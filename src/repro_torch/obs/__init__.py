"""repro_torch.obs — the span tracer (copied from ``repro.obs``) with a
torch device fence in :mod:`.timing`.

* :class:`Tracer` / :class:`Span` — spans, instants, counters on wall and
  sim-time tracks; ``to_chrome_trace()`` / ``to_records()`` / ``summary()``.
* :func:`current_tracer` / :func:`use_tracer` — process-global registry.
* :func:`device_span` — ``torch.cuda.synchronize``-fenced wall timing.
* ``python -m repro_torch.obs.validate out.json`` — trace schema checker.
"""
from .tracer import STAGE_CATS, Span, Tracer, current_tracer, use_tracer
from .timing import device_fence, device_span
from .export import summary as trace_summary
from .validate import check_trace

__all__ = [
    "STAGE_CATS", "Span", "Tracer", "current_tracer", "use_tracer",
    "device_fence", "device_span", "trace_summary", "check_trace",
]
