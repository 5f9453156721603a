"""Dense GQA attention — the port of the GQA half of
``repro.models.attention`` (RoPE, causal softmax attention, single-token
decode over a KV cache).

The reference's ``flash_attention`` is jnp, not Pallas: a blockwise
online softmax that bounds XLA's compiled memory.  Here it is plain torch
— the masked score matrix in float32, one softmax — which computes the
same function; serving prompts are short, so the (T, T) scores are small.
Layouts follow the reference: (B, T, H, D) activations, ``wq`` (d, Hq,
Dh), ``wo`` (Hq, Dh, d).  MLA, cross-attention and sliding-window rings
are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .config import ArchConfig
from .layers import _normal

__all__ = ["init_gqa", "apply_gqa", "rope", "flash_attention",
           "gqa_cache_spec"]


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, T, H, D) with even D; positions: (B, T)."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs     # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    kv_valid: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with the reference's masks.

    q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, Dk/Dv).  Hq % Hkv == 0 (GQA).
    ``q_offset`` is the absolute position of q[0]; ``kv_valid`` masks a
    padded KV cache (scalar or (B,)).  Returns (B, Tq, Hq, Dv)."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()                       # (B, Hkv, Tk, D)
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kh) * scale
    qp = q_offset + torch.arange(Tq, device=q.device)[:, None]
    kp = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    full = mask[None, None, None]
    if kv_valid is not None:
        kvv = torch.as_tensor(kv_valid, device=q.device).reshape(-1)
        full = full & (kp[0] < kvv[:, None])[:, None, None, None, :]
    s = s.masked_fill(~full, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vh)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, Dv).to(q.dtype)


def _decode_attention(q, k_cache, v_cache, kv_valid, *, scale=None):
    """Single-token attention over a (possibly padded) KV cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D).  kv_valid: (B,) count of
    valid cache slots (the new token's K/V already written)."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qh.float(), k_cache.float()) * scale
    kp = torch.arange(S, device=q.device)
    valid = kp[None, :] < kv_valid.reshape(-1, 1)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(Hq * Dh)
    return {
        "wq": _normal(gen, (d, Hq, Dh), dtype, device) * s,
        "wk": _normal(gen, (d, Hkv, Dh), dtype, device) * s,
        "wv": _normal(gen, (d, Hkv, Dh), dtype, device) * s,
        "wo": _normal(gen, (Hq, Dh, d), dtype, device) * so,
    }


def apply_gqa(params: dict, x: torch.Tensor, *, cfg: ArchConfig,
              rope_base: float = 10_000.0,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, T, d).  Training/prefill when cache is None or being filled;
    decode (T == 1) when ``cache`` has 'k','v','len'.  The KV cache is
    updated in place (the reference returns a fresh copy; the returned
    dict holds the same tensors either way)."""
    B, T, d = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    q = torch.einsum("btd,dhx->bthx", x, params["wq"])
    k = torch.einsum("btd,dhx->bthx", x, params["wk"])
    v = torch.einsum("btd,dhx->bthx", x, params["wv"])
    q = rope(q, positions, rope_base)
    k = rope(k, positions, rope_base)

    if cache is None:
        o = flash_attention(q, k, v, causal=True)
        new_cache = None
    elif T > 1:
        # prefill: attend over the fresh K/V, then fill the cache
        o = flash_attention(q, k, v, causal=True)
        k_cache, v_cache = cache["k"], cache["v"]
        S = k_cache.shape[1]
        if T >= S:
            # ring smaller than prompt → keep the tail, aligned so that
            # token p sits in slot p % S
            shift = (T - S) % S
            k_cache.copy_(torch.roll(k[:, -S:], shift, dims=1))
            v_cache.copy_(torch.roll(v[:, -S:], shift, dims=1))
        else:
            k_cache[:, :T] = k
            v_cache[:, :T] = v
        kv_valid = torch.clamp(positions[:, -1] + 1, max=S).to(torch.int32)
        new_cache = {"k": k_cache, "v": v_cache, "len": kv_valid}
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        S = k_cache.shape[1]
        slot = positions[:, 0] % S
        b = torch.arange(B, device=x.device)
        k_cache[b, slot] = k[:, 0]
        v_cache[b, slot] = v[:, 0]
        kv_valid = torch.clamp(positions[:, -1] + 1, max=S).to(torch.int32)
        o = _decode_attention(q, k_cache, v_cache, kv_valid)
        new_cache = {"k": k_cache, "v": v_cache, "len": kv_valid}
    out = torch.einsum("bthx,hxd->btd", o, params["wo"])
    return out, new_cache


def gqa_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   dtype) -> dict:
    """Shape/dtype template of a decode cache."""
    shp = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": (shp, dtype), "v": (shp, dtype),
            "len": ((batch,), torch.int32)}
