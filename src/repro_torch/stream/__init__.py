"""repro_torch.stream — event-driven streaming over the paper's planner.

The event model, share ledger, admission policies, online planner, step
barrier and metrics are byte-identical copies of ``repro.stream``; the
config differs only in its backends (``"numpy"`` | ``"torch"``); the
batched numerics in :mod:`.backend` carry a ``"torch"`` engine in place of
the jax one; :class:`StreamingExecutor` (:mod:`.engine`) is the
reference's event loop with its verification numerics on the card.
"""
from .backend import (ExponentialBlock, completion_times, decode_batch,
                      delivered_by, sample_delays)
from .barrier import BarrierTask, StepBarrier, churn_finish_update
from .config import BackendConfig, StreamConfig
from .engine import StreamingExecutor, poisson_sources
from .events import (ARRIVAL, CHURN, COMPLETION, REPLAN, Event, EventLoop,
                     PoissonProcess, TraceProcess, WorkerEvent)
from .metrics import StreamMetrics, TaskRecord
from .queueing import (AdmissionConfig, AdmissionPolicy, EDFAdmission,
                       FairShareAdmission, FIFOAdmission, SharePool,
                       WaitQueue, make_admission_policy, maxmin_share)
from .replan import OnlinePlanner, ReplanMode, ReplanPolicy, scaled_row_loads

__all__ = [
    "StreamingExecutor", "poisson_sources",
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
