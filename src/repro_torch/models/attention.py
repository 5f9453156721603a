"""Attention layers — the port of ``repro.models.attention``: GQA (with
sliding-window rings), MLA (DeepSeek-V3) and cross-attention (the
encoder-decoder's decoder), RoPE, single-token decode over a KV cache.

The reference's ``flash_attention`` is jnp, not Pallas: a blockwise
online softmax that keeps no (T, T) scores and visits only the key blocks
its causal / window masks leave.  Here it is the ``attention`` operator
(:mod:`repro_torch.kernels.attention`): the hand-written kernels
``csrc/attention.cu`` and ``csrc/attention_bwd.cu`` on CUDA tensors, the
plain blockwise port on CPU tensors, with the same bounded memory and
masked work.  Layouts follow the reference: (B, T, H, D) activations,
``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d).  Products promote their operands
as ``jnp``'s do (:func:`.layers.einsum`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.attention import attention_op
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
                    block_q: int = 512, block_k: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise softmax attention with the reference's masks.

    q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, Dk/Dv).  Hq % Hkv == 0 (GQA).
    ``q_offset`` is the absolute position of q[0]; ``kv_valid`` masks a
    padded KV cache (scalar or (B,)).  ``block_q`` / ``block_k`` are the
    reference's blocks, which the plain version (CPU tensors) runs and the
    FLOP count reads; the kernels tile by their plan.  A row that sees no
    key is 0 (the reference's is NaN under a window).  Returns (B, Tq, Hq,
    Dv), differentiable."""
    B, D = q.shape[0], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if kv_valid is not None:
        kv_valid = torch.as_tensor(kv_valid, device=q.device).to(
            torch.int32).reshape(-1).expand(B).contiguous()
    # mixed types (a bf16 decoder's queries against a float32 encoder's
    # keys) meet in the promoted type, as the reference's products do
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out, _ = attention_op(q.to(dt).contiguous(), k.to(dt).contiguous(),
                          v.to(dt).contiguous(), kv_valid, causal, window,
                          int(q_offset), float(scale), block_q, block_k)
    return out.to(q.dtype)


def _put(cache: torch.Tensor, idx: tuple, value: torch.Tensor) -> None:
    """``cache[idx] = value`` in place (``idx`` () for the whole cache).  A
    cache under a mesh is a DTensor replicated over it: every rank writes
    the whole value into its local copy (a sharded index write has no
    DTensor rule)."""
    from ..parallel.ops import is_dtensor
    if is_dtensor(cache):
        def full(t):
            return t.full_tensor() if is_dtensor(t) else t
        cache, value = cache.to_local(), full(value)
        idx = tuple(full(i) for i in idx)
    if idx:
        cache[idx] = value
    else:
        cache.copy_(value)


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=1)`` for 0 <= shift < x.shape[1], as
    two slices: ``roll`` has no DTensor rule on every torch release."""
    if shift == 0:
        return x
    return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def _heads(fn, q, k, v, kv_valid=None):
    """``fn(q, k, v, kv_valid)``, an attention over heads: q (B, Tq, Hq,
    D), k / v (B, Tk, Hkv, D), kv_valid (B,) or None.  On DTensors it runs
    under ``local_map``, heads on the "model" dim when it divides Hq and
    Hkv (each rank attends with its heads; else every rank computes all
    heads): attention is per head, and flattening a sharded head dim has
    no DTensor rule."""
    from ..parallel.ops import is_dtensor, per_head
    if not is_dtensor(q):
        return fn(q, k, v, kv_valid)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    x_pl = per_head(q, 2, q.shape[2], k.shape[2])
    kv_pl = None
    if kv_valid is not None:
        kv_pl = per_head(q, None)
        if not is_dtensor(kv_valid):
            kv_valid = DTensor.from_local(
                torch.as_tensor(kv_valid, device=q.device).reshape(-1),
                mesh, [Replicate()] * mesh.ndim, run_check=False)
    return local_map(fn, out_placements=x_pl,
                     in_placements=(x_pl, x_pl, x_pl, kv_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, kv_valid)


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

    def attend(q, k, v, _):
        return flash_attention(q, k, v, causal=True, window=window)

    if cache is None:
        o = _heads(attend, q, k, v)
        new_cache = None
    elif T > 1:
        # prefill: attend over the fresh K/V, then fill the cache
        o = _heads(attend, q, k, v)
        k_cache, v_cache = cache["k"], cache["v"]
        S = k_cache.shape[1]
        if T >= S:
            # ring smaller than prompt → keep the tail, aligned so that
            # token p sits in slot p % S
            shift = (T - S) % S
            _put(k_cache, (), _roll(k[:, -S:], shift))
            _put(v_cache, (), _roll(v[:, -S:], shift))
        else:
            _put(k_cache, (slice(None), slice(0, T)), k)
            _put(v_cache, (slice(None), slice(0, T)), v)
        kv_valid = torch.clamp(positions[:, -1] + 1, max=S).to(torch.int32)
        new_cache = {"k": k_cache, "v": v_cache, "len": kv_valid}
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        S = k_cache.shape[1]
        slot = positions[:, 0] % S
        b = torch.arange(B, device=x.device)
        _put(k_cache, (b, slot), k[:, 0])
        _put(v_cache, (b, slot), v[:, 0])
        kv_valid = torch.clamp(positions[:, -1] + 1, max=S).to(torch.int32)
        # the window is the ring's size
        o = _heads(_decode_attention, q, k_cache, v_cache, kv_valid)
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
        o = _heads(lambda q_, k_, v_, _: flash_attention(
            q_, k_, v_, causal=True, scale=scale), qq, k, v)
        new_cache = None
        if cache is not None:   # prefill: stash the compressed latents
            _put(cache["c"], (slice(None), slice(0, T)), c_kv)
            _put(cache["r"], (slice(None), slice(0, T)), k_rope[:, :, 0, :])
            new_cache = {"c": cache["c"], "r": cache["r"],
                         "len": positions[:, -1] + 1}
    else:
        # absorbed decode: q_eff = W_kb^T q_nope lives in latent space
        q_lat_abs = einsum("bthx,rhx->bthr", q_nope, params["wk_b"])
        c_cache, r_cache = cache["c"], cache["r"]
        b = torch.arange(B, device=x.device)
        slot = positions[:, 0]
        _put(c_cache, (b, slot), c_kv[:, 0])
        _put(r_cache, (b, slot), k_rope[:, 0, 0, :])
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
    o = _heads(lambda q_, k_, v_, _: flash_attention(q_, k_, v_,
                                                     causal=False), q, k, v)
    return einsum("bthx,hxd->btd", o, params["wo"])
