"""Honest wall timing around device work.

CUDA launches are asynchronous: an unfenced ``perf_counter`` pair around a
kernel call times the enqueue, not the compute.  :func:`device_span` fences
the exit with ``torch.cuda.synchronize()`` when the body registered a CUDA
tensor, so the recorded wall span covers the device work.  The fence only
happens while a tracer is recording: with tracing off the launch stream is
untouched.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import torch

from .tracer import Tracer, current_tracer

__all__ = ["device_fence", "device_span"]


def _on_cuda(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    return False


def device_fence(x: Any) -> Any:
    """Wait for the card when ``x`` holds a CUDA tensor; return ``x``."""
    if _on_cuda(x):
        torch.cuda.synchronize()
    return x


class _Fence:
    """Mutable holder the ``device_span`` body loads its result into."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Any = None

    def __call__(self, x: Any) -> Any:
        self.value = x
        return x


@contextlib.contextmanager
def device_span(name: str, *, cat: str = "kernel", track: str = "wall",
                args: Optional[Dict[str, Any]] = None,
                tr: Optional[Tracer] = None) -> Iterator[_Fence]:
    """Fenced wall span.  Usage::

        with device_span("coded_shard_matmul_batch", cat="kernel") as fence:
            out = fence(kernel(...))   # synchronised at span exit

    With no active tracer the body runs untouched (no fence, no timing).
    """
    tr = tr if tr is not None else current_tracer()
    fence = _Fence()
    if tr is None:
        yield fence
        return
    with tr.span(name, cat=cat, track=track, args=args) as a:
        yield fence
        if fence.value is not None:
            device_fence(fence.value)
        a.setdefault("fenced", fence.value is not None)
