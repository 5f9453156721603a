"""repro_torch — the PyTorch / CUDA port of :mod:`repro`.

The layout mirrors ``repro`` module for module (``repro_torch.core``,
``repro_torch.kernels``, ``repro_torch.models``,
``repro_torch.serve_coded``, ``repro_torch.runtime``, …) so each port
module sits opposite the module it is tested against.  The numpy-only
modules (the planner, the stream event machinery, the chaos layer, the
tracer, the configs) are byte-identical copies; everything that touches
the device is PyTorch, and every Pallas kernel of the ported paths (coded
serving, the static executor, the streaming verify) is a hand-written
CUDA kernel for Hopper (``repro_torch/csrc``) with a plain-torch twin used
only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).  The package imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
