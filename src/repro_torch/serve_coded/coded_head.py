"""Deprecated shim — ``CodedLMHead``/``HeadStep`` live in
:mod:`repro_torch.serve_coded.coded_linear` (the head is just the
``CodedLinear`` named ``"head"``).

Import from ``repro_torch.serve_coded`` (or ``.coded_linear``) instead;
this module is kept for one release and will be removed.
"""
from __future__ import annotations

import warnings

from .coded_linear import CodedLMHead, HeadStep  # noqa: F401

__all__ = ["CodedLMHead", "HeadStep"]

warnings.warn(
    "repro_torch.serve_coded.coded_head is deprecated; import CodedLMHead / "
    "HeadStep from repro_torch.serve_coded (they live in coded_linear now)",
    DeprecationWarning, stacklevel=2)
