"""Mamba (selective SSM) mixer for the Jamba hybrid stack — the port of
``repro.models.ssm``.

h_t = exp(Δ_t A) ⊙ h_{t-1} + Δ_t B_t x_t,   y_t = C_tᵀ h_t + D x_t,
with diagonal A (d_inner, d_state), data-dependent (Δ, B, C), causal
depthwise conv front-end, and a SiLU gate — Mamba-1 per Jamba.

The recurrence runs step by step in float32, as the reference's
``lax.scan`` does, forming α and β inside each step: the (B, T, d_inner,
d_state) tensors are never materialised.  Decode carries (h, the
pre-conv tail of the input projection) through the cache; ``a_log`` and
``h`` are float32 in every config.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig, MambaConfig
from .layers import _normal, einsum

__all__ = ["init_mamba", "apply_mamba", "mamba_cache_spec"]


def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype,
               device=None) -> dict:
    mc = cfg.mamba or MambaConfig()
    d = cfg.d_model
    di = mc.expand * d
    N = mc.d_state
    s = 1.0 / math.sqrt(d)
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "w_in": _normal(gen, (d, 2 * di), dtype, device) * s,
        "conv": _normal(gen, (mc.d_conv, di), dtype, device) * 0.2,
        "w_bcdt": _normal(gen, (di, 2 * N + 1), dtype, device)
        / math.sqrt(di),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=device),
        "a_log": torch.log(a).expand(di, N).contiguous(),
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "w_out": _normal(gen, (di, d), dtype, device) / math.sqrt(di),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, T, di), w: (K, di).
    ``carry``: (B, K-1, di) previous tail for decode continuity."""
    K, T = w.shape[0], x.shape[1]
    if carry is None:
        carry = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    out = xp[:, :T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out


def apply_mamba(params: dict, x: torch.Tensor, *, cfg: ArchConfig,
                cache: Optional[dict] = None,
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, T, d) → (B, T, d).  cache: {'h': (B, di, N), 'conv':
    (B, K-1, di)}; the returned cache holds new tensors."""
    mc = cfg.mamba or MambaConfig()
    B, T, d = x.shape
    di = mc.expand * d
    N = mc.d_state

    xz = einsum("btd,de->bte", x, params["w_in"])
    xs, z = xz[..., :di], xz[..., di:]
    conv_carry = cache["conv"] if cache is not None else None
    xs = F.silu(_conv_causal(xs, params["conv"], conv_carry))

    bcdt = einsum("bti,ie->bte", xs, params["w_bcdt"])
    Bm, Cm = bcdt[..., :N], bcdt[..., N:2 * N]
    dt = F.softplus(bcdt[..., -1:] + params["dt_bias"])          # (B,T,di)
    A = -torch.exp(params["a_log"])                               # (di, N)

    h = (cache["h"].float() if cache is not None
         else x.new_zeros((B, di, N), dtype=torch.float32))
    ys = []
    for t in range(T):
        dt_t, x_t = dt[:, t], xs[:, t]
        alpha = torch.exp(dt_t.float()[..., None] * A)            # (B,di,N)
        beta = (dt_t * x_t).float()[..., None] \
            * Bm[:, t].float()[:, None, :]
        h = alpha * h + beta
        ys.append(torch.einsum("bin,bn->bi", h, Cm[:, t].float()))
    y = torch.stack(ys, dim=1).to(x.dtype)                        # (B,T,di)
    y = y + params["d_skip"] * xs
    y = y * F.silu(z)
    out = einsum("bti,id->btd", y, params["w_out"])

    new_cache = None
    if cache is not None:
        K = mc.d_conv
        tail = torch.cat([cache["conv"], xz[..., :di]], dim=1)[:, -(K - 1):]
        new_cache = {"h": h.to(cache["h"].dtype), "conv": tail}
    return out, new_cache


def mamba_cache_spec(cfg: ArchConfig, batch: int, dtype) -> dict:
    mc = cfg.mamba or MambaConfig()
    di = mc.expand * cfg.d_model
    return {"h": ((batch, di, mc.d_state), torch.float32),
            "conv": ((batch, mc.d_conv - 1, di), dtype)}
