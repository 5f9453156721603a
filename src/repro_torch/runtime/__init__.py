"""repro_torch.runtime — coded execution, coded gradient aggregation,
straggler baselines and the training loop, on the card."""
from .coded_exec import CodedExecutor, ExecutionReport  # noqa: F401
from .coded_grads import coded_grad_aggregate, encode_grad_shards  # noqa: F401
from .straggler import BackupTaskPolicy, DeadlinePolicy  # noqa: F401
from .train_loop import TrainLoop, TrainLoopConfig  # noqa: F401

__all__ = ["CodedExecutor", "ExecutionReport", "coded_grad_aggregate",
           "encode_grad_shards", "BackupTaskPolicy", "DeadlinePolicy",
           "TrainLoop", "TrainLoopConfig"]
