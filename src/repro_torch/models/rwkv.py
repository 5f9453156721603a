"""RWKV-6 ("Finch") mixer: data-dependent decay time-mix + channel-mix —
the port of ``repro.models.rwkv``.

Every branch of the time-mix (full sequence, prefill, one-token decode)
runs its WKV recurrence through :func:`repro_torch.kernels.ops.wkv6_heads`:
the hand-written kernel on the card, the plain chunked version on the CPU.
Every branch also trains: the call is differentiable through
:func:`repro_torch.kernels.wkv6.wkv6_op`, whose backward is the
hand-written ``csrc/wkv6_bwd.cu`` on the card and its plain twin on the
CPU; ``u``'s float32 cast and the decays' cast to the activation type
carry the gradients back to the parameters' type, as the reference's
``astype`` does.  Decode carries (token-shift states, per-head float32
WKV state).  The numerics follow the reference: decays cast to the
activation type before the WKV, ``u`` in float32, the output norm at
``rms_norm``'s default eps, and prefill starting its WKV state from zeros
whatever the cache holds.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import ops as pops
from .config import ArchConfig
from .layers import _normal, rms_norm

__all__ = ["init_rwkv_tmix", "apply_rwkv_tmix", "init_rwkv_cmix",
           "apply_rwkv_cmix", "rwkv_cache_spec"]

_LORA = 64


def _uniform(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device).to(dtype)


def init_rwkv_tmix(gen: torch.Generator, cfg: ArchConfig, dtype,
                   device=None) -> dict:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    s = 1.0 / math.sqrt(d)
    return {
        "mu": _uniform(gen, (5, d), dtype, device),      # r,k,v,w,g shifts
        "wr": _normal(gen, (d, d), dtype, device) * s,
        "wk": _normal(gen, (d, d), dtype, device) * s,
        "wv": _normal(gen, (d, d), dtype, device) * s,
        "wg": _normal(gen, (d, d), dtype, device) * s,
        "w0": torch.full((d,), -2.0, dtype=dtype, device=device),
        "w_lora_a": _normal(gen, (d, _LORA), dtype, device) * s,
        "w_lora_b": _normal(gen, (_LORA, d), dtype, device) * 0.01,
        "u": _normal(gen, (H, hs), dtype, device) * 0.1,
        "wo": _normal(gen, (d, d), dtype, device) * s,
        "ln_g": torch.ones((d,), dtype=dtype, device=device),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """Previous-token tensor; ``last`` (B, d) continues across decode
    steps."""
    last = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([last, x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u, state):
    """:func:`repro_torch.kernels.ops.wkv6_heads`; on DTensors under
    ``local_map`` with the heads (dim 1; u's dim 0) on the "model" dim
    when it divides them: the WKV is per head, so every rank runs the
    kernel on its heads."""
    if not pops.is_dtensor(r):
        return ops.wkv6_heads(r, k, v, w, u, state)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x_pl = pops.per_head(r, 1, r.shape[1])
    # u (H, K): its heads where r's are, whole over the data dims
    u_pl = [Shard(0) if a == "model" and isinstance(p, Shard)
            else Replicate()
            for a, p in zip(r.device_mesh.mesh_dim_names, x_pl)]
    in_pl = (x_pl, x_pl, x_pl, x_pl, u_pl, None if state is None else x_pl)
    return local_map(ops.wkv6_heads, out_placements=(x_pl, x_pl),
                     in_placements=in_pl, device_mesh=r.device_mesh,
                     redistribute_inputs=True)(r, k, v, w, u, state)


def apply_rwkv_tmix(params: dict, x: torch.Tensor, *, cfg: ArchConfig,
                    cache: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    prev = _token_shift(x, cache["shift_t"] if cache is not None else None)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (x + (prev - x) * mu[i] for i in range(5))

    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = F.silu(xg @ params["wg"])
    w_log = params["w0"] + (torch.tanh(xw @ params["w_lora_a"])
                            @ params["w_lora_b"])
    w = torch.exp(-torch.exp(w_log.float()))                # decay ∈ (0,1)

    def heads(t):
        return t.reshape(B, T, H, hs).transpose(1, 2)

    u = params["u"].float()
    # prefill starts from zeros (as the reference does); decode continues
    # the cached state
    state = cache["wkv"] if cache is not None and T == 1 else None
    o, S = _wkv(heads(r), heads(k), heads(v), heads(w.to(x.dtype)), u,
                state)
    new_cache = None
    if cache is not None:
        new_cache = {"wkv": S.to(cache["wkv"].dtype), "shift_t": x[:, -1],
                     "shift_c": cache["shift_c"]}

    o = o.transpose(1, 2).reshape(B, T, d)
    o = rms_norm(o, params["ln_g"]) * g
    return o @ params["wo"], new_cache


def init_rwkv_cmix(gen: torch.Generator, cfg: ArchConfig, dtype,
                   device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": _uniform(gen, (2, d), dtype, device),
        "wk": _normal(gen, (d, f), dtype, device) / math.sqrt(d),
        "wv": _normal(gen, (f, d), dtype, device) / math.sqrt(f),
        "wr": _normal(gen, (d, d), dtype, device) / math.sqrt(d),
    }


def apply_rwkv_cmix(params: dict, x: torch.Tensor, *,
                    cache: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    prev = _token_shift(x, cache["shift_c"] if cache is not None else None)
    mu = params["mu"]
    xk = x + (prev - x) * mu[0]
    xr = x + (prev - x) * mu[1]
    k = torch.square(F.relu(xk @ params["wk"]))
    out = torch.sigmoid(xr @ params["wr"]) * (k @ params["wv"])
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["shift_c"] = x[:, -1]
    return out, new_cache


def rwkv_cache_spec(cfg: ArchConfig, batch: int, dtype) -> dict:
    """``(shape, dtype)`` leaves of one layer's decode cache."""
    hs = cfg.rwkv_head_size
    H = cfg.d_model // hs
    return {"wkv": ((batch, H, hs, hs), torch.float32),
            "shift_t": ((batch, cfg.d_model), dtype),
            "shift_c": ((batch, cfg.d_model), dtype)}
