"""repro_torch.runtime — the paper's static coded executor on the card.

Only :class:`CodedExecutor` / :class:`ExecutionReport` are ported; the
training runtime (``coded_grads``, ``straggler``, ``train_loop``) belongs to
a later slice.
"""
from .coded_exec import CodedExecutor, ExecutionReport  # noqa: F401

__all__ = ["CodedExecutor", "ExecutionReport"]
