"""Attention layers — the port of ``repro.models.attention``: GQA (with
sliding-window rings), MLA (DeepSeek-V3) and cross-attention (the
encoder-decoder's decoder), RoPE, single-token decode over a KV cache.

The reference's ``flash_attention`` is jnp, not Pallas: a blockwise
online softmax that bounds XLA's compiled memory.  Here it is plain torch
— the masked score matrix in float32, one softmax — which computes the
same function; serving prompts are short, so the (T, T) scores are small.
Layouts follow the reference: (B, T, H, D) activations, ``wq`` (d, Hq,
Dh), ``wo`` (Hq, Dh, d).  Products promote their operands as ``jnp``'s
do (:func:`.layers.einsum`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .config import ArchConfig, MLAConfig
from .layers import _normal, einsum

__all__ = ["init_gqa", "apply_gqa", "init_mla", "apply_mla",
           "init_cross", "apply_cross", "rope", "flash_attention",
           "gqa_cache_spec", "mla_cache_spec"]


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
              window: Optional[int] = None, rope_base: float = 10_000.0,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, T, d).  Training/prefill when cache is None or being filled;
    decode (T == 1) when ``cache`` has 'k','v','len'.  A ``window``
    masks the prefill to the last ``window`` keys; its cache is a ring of
    ``min(max_len, window)`` slots, token p in slot p % S, so decode
    attends over the whole ring.  The KV cache is updated in place (the
    reference returns a fresh copy; the returned dict holds the same
    tensors either way)."""
    B, T, d = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    q = einsum("btd,dhx->bthx", x, params["wq"])
    k = einsum("btd,dhx->bthx", x, params["wk"])
    v = einsum("btd,dhx->bthx", x, params["wv"])
    q = rope(q, positions, rope_base)
    k = rope(k, positions, rope_base)

    if cache is None:
        o = flash_attention(q, k, v, causal=True, window=window)
        new_cache = None
    elif T > 1:
        # prefill: attend over the fresh K/V, then fill the cache
        o = flash_attention(q, k, v, causal=True, window=window)
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
        # the window is the ring's size
        o = _decode_attention(q, k_cache, v_cache, kv_valid)
        new_cache = {"k": k_cache, "v": v_cache, "len": kv_valid}
    out = einsum("bthx,hxd->btd", o, params["wo"])
    return out, new_cache


def gqa_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   window: Optional[int], dtype) -> dict:
    """Shape/dtype template of a decode cache (a ring for windows)."""
    S = min(max_len, window) if window is not None else max_len
    shp = (batch, S, cfg.n_kv_heads, cfg.d_head)
    return {"k": (shp, dtype), "v": (shp, dtype),
            "len": ((batch,), torch.int32)}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    s = 1.0 / math.sqrt(d)
    sq = 1.0 / math.sqrt(m.q_lora)
    sk = 1.0 / math.sqrt(m.kv_lora)
    return {
        "wq_a": _normal(gen, (d, m.q_lora), dtype, device) * s,
        "wq_b": _normal(gen, (m.q_lora, H, m.nope_dim + m.rope_dim), dtype,
                        device) * sq,
        "wkv_a": _normal(gen, (d, m.kv_lora + m.rope_dim), dtype,
                         device) * s,
        "wk_b": _normal(gen, (m.kv_lora, H, m.nope_dim), dtype, device) * sk,
        "wv_b": _normal(gen, (m.kv_lora, H, m.v_dim), dtype, device) * sk,
        "wo": _normal(gen, (H, m.v_dim, d), dtype, device)
        / math.sqrt(H * m.v_dim),
        "q_norm": torch.ones((m.q_lora,), dtype=dtype, device=device),
        "kv_norm": torch.ones((m.kv_lora,), dtype=dtype, device=device),
    }


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6):
    """MLA's latent norm: a fixed eps, the gain applied before the cast
    (``layers.rms_norm`` casts first)."""
    n = x * torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    return (n * g).to(x.dtype)


def apply_mla(params: dict, x: torch.Tensor, *, cfg: ArchConfig,
              rope_base: float = 10_000.0,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA.  Full sequence and prefill expand the latent into per-head
    K/V; prefill stashes the compressed latent ``c`` and the shared rope
    key ``r`` in the cache.  Decode is the *absorbed* form: ``q_nope`` is
    projected through ``wk_b`` into the latent space and attention runs
    over the (kv_lora + rope) cache in float32.  Caches update in
    place."""
    m: MLAConfig = cfg.mla
    B, T, d = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)

    q_lat = _rms(einsum("btd,dr->btr", x, params["wq_a"]), params["q_norm"])
    q = einsum("btr,rhx->bthx", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = rope(q_rope, positions, rope_base)

    kv = einsum("btd,dr->btr", x, params["wkv_a"])
    c_kv = _rms(kv[..., :m.kv_lora], params["kv_norm"])   # (B, T, kv_lora)
    k_rope = rope(kv[..., m.kv_lora:][:, :, None, :], positions, rope_base)

    scale = 1.0 / math.sqrt(m.nope_dim + m.rope_dim)

    if cache is None or T > 1:
        k_nope = einsum("btr,rhx->bthx", c_kv, params["wk_b"])
        v = einsum("btr,rhx->bthx", c_kv, params["wv_b"])
        k = torch.cat([k_nope, k_rope.expand(B, T, H, m.rope_dim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(qq, k, v, causal=True, scale=scale)
        new_cache = None
        if cache is not None:   # prefill: stash the compressed latents
            cache["c"][:, :T] = c_kv
            cache["r"][:, :T] = k_rope[:, :, 0, :]
            new_cache = {"c": cache["c"], "r": cache["r"],
                         "len": positions[:, -1] + 1}
    else:
        # absorbed decode: q_eff = W_kb^T q_nope lives in latent space
        q_lat_abs = einsum("bthx,rhx->bthr", q_nope, params["wk_b"])
        c_cache, r_cache = cache["c"], cache["r"]
        b = torch.arange(B, device=x.device)
        slot = positions[:, 0]
        c_cache[b, slot] = c_kv[:, 0]
        r_cache[b, slot] = k_rope[:, 0, 0, :]
        kv_valid = positions[:, -1] + 1
        s_lat = torch.einsum("bthr,bsr->bhts", q_lat_abs.float(),
                             c_cache.float())
        s_rope = torch.einsum("bthx,bsx->bhts", q_rope.float(),
                              r_cache.float())
        s = (s_lat + s_rope) * scale
        valid = torch.arange(c_cache.shape[1],
                             device=x.device)[None, :] < kv_valid[:, None]
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhts,bsr->bthr", p, c_cache.float())
        o = einsum("bthr,rhx->bthx", o_lat.to(x.dtype), params["wv_b"])
        new_cache = {"c": c_cache, "r": r_cache, "len": kv_valid}

    out = einsum("bthx,hxd->btd", o, params["wo"])
    return out, new_cache


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   dtype) -> dict:
    m = cfg.mla
    return {"c": ((batch, max_len, m.kv_lora), dtype),
            "r": ((batch, max_len, m.rope_dim), dtype),
            "len": ((batch,), torch.int32)}


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec decoder)
# ---------------------------------------------------------------------------

def init_cross(gen: torch.Generator, cfg: ArchConfig, dtype,
               device=None) -> dict:
    return init_gqa(gen, cfg, dtype, device)


def apply_cross(params: dict, x: torch.Tensor, enc: torch.Tensor, *,
                cfg: ArchConfig) -> torch.Tensor:
    """x: (B, Tq, d) decoder states; enc: (B, Tk, d) encoder output."""
    q = einsum("btd,dhx->bthx", x, params["wq"])
    k = einsum("btd,dhx->bthx", enc, params["wk"])
    v = einsum("btd,dhx->bthx", enc, params["wv"])
    o = flash_attention(q, k, v, causal=False)
    return einsum("bthx,hxd->btd", o, params["wo"])
