"""repro_torch.stream — the stream planner's serving-side machinery.

The event model, share ledger, admission policies, online planner, step
barrier and metrics are byte-identical copies of ``repro.stream``; the
batched numerics in :mod:`.backend` carry a ``"torch"`` engine in place of
the jax one.  The streaming executor (``repro.stream.engine``) is not
ported yet.
"""
from .backend import (ExponentialBlock, completion_times, decode_batch,
                      delivered_by, sample_delays)
from .barrier import BarrierTask, StepBarrier, churn_finish_update
from .config import BackendConfig, StreamConfig
from .events import (ARRIVAL, CHURN, COMPLETION, REPLAN, Event, EventLoop,
                     PoissonProcess, TraceProcess, WorkerEvent)
from .metrics import StreamMetrics, TaskRecord
from .queueing import (AdmissionConfig, AdmissionPolicy, EDFAdmission,
                       FairShareAdmission, FIFOAdmission, SharePool,
                       WaitQueue, make_admission_policy, maxmin_share)
from .replan import OnlinePlanner, ReplanMode, ReplanPolicy, scaled_row_loads

__all__ = [
    "StreamConfig", "BackendConfig", "ReplanMode",
    "EventLoop", "Event", "PoissonProcess", "TraceProcess", "WorkerEvent",
    "ARRIVAL", "COMPLETION", "CHURN", "REPLAN",
    "AdmissionConfig", "SharePool", "WaitQueue",
    "AdmissionPolicy", "FIFOAdmission", "EDFAdmission", "FairShareAdmission",
    "make_admission_policy", "maxmin_share",
    "OnlinePlanner", "ReplanPolicy", "scaled_row_loads",
    "StreamMetrics", "TaskRecord",
    "completion_times", "delivered_by", "sample_delays", "decode_batch",
    "ExponentialBlock",
    "BarrierTask", "StepBarrier", "churn_finish_update",
]
