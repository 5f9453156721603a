"""Shared building blocks: RMSNorm, dense FFN variants, embeddings — the
port of ``repro.models.layers`` (plain functions on tensors; parameter
layouts and dtype rules as in the reference)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ArchConfig

__all__ = ["rms_norm", "init_rms", "init_ffn", "apply_ffn",
           "ffn_weight_names", "init_embedding", "embed", "logits",
           "promote", "einsum"]


def ffn_weight_names(act: str) -> tuple:
    """The dense-FFN weight matrices of ``act``, in application order."""
    if act == "swiglu":
        return ("w_in", "w_gate", "w_out")
    if act in ("gelu", "relu2"):
        return ("w_in", "w_out")
    raise ValueError(act)


def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normal draw in float32, cast to ``dtype`` (the reference
    draws in the parameter dtype; values differ anyway across frameworks)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def promote(*ts):
    """The operands in their common dtype, as ``jnp``'s products promote:
    a float32 activation (an encoder's or a frontend's, from float32
    features) against bfloat16 weights computes in float32."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def einsum(eq: str, *ts) -> torch.Tensor:
    """``torch.einsum`` with ``jnp.einsum``'s dtype promotion."""
    return torch.einsum(eq, *promote(*ts))


def init_rms(d: int, dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    n = x * torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    return n.to(x.dtype) * gain


def init_ffn(gen: torch.Generator, d: int, d_ff: int, act: str, dtype,
             device=None) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"w_in": _normal(gen, (d, d_ff), dtype, device) * s_in,
         "w_out": _normal(gen, (d_ff, d), dtype, device) * s_out}
    if act == "swiglu":
        p["w_gate"] = _normal(gen, (d, d_ff), dtype, device) * s_in
    return p


def apply_ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = einsum("btd,df->btf", x, params["w_in"])
    if act == "swiglu":
        h = F.silu(einsum("btd,df->btf", x, params["w_gate"])) * h
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    elif act == "relu2":                    # Nemotron-4 squared ReLU
        h = F.relu(h).square()
    else:
        raise ValueError(act)
    return einsum("btf,fd->btd", h, params["w_out"])


def init_embedding(gen: torch.Generator, cfg: ArchConfig, dtype,
                   device=None) -> dict:
    p = {"tok": _normal(gen, (cfg.vocab, cfg.d_model), dtype, device) * 0.02}
    if not cfg.tie_embeddings:
        p["out"] = _normal(gen, (cfg.d_model, cfg.vocab), dtype, device) \
            / math.sqrt(cfg.d_model)
    return p


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return einsum("btd,vd->btv", x, params["tok"])
    return einsum("btd,dv->btv", x, params["out"])
