"""Plain-PyTorch versions of every kernel of the port (coded serving, the
static executor, the streaming verify, the RWKV-6 WKV recurrence, the
blockwise attention and its backward).

The CPU tests run these (a wrapper takes them only for CPU tensors) and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  They
repeat the kernels' arithmetic and are no yardstick of speed.

The counter-derived parity rows need uint32 wrap-around, which torch's
integer ops do not offer on every device: the threefry rounds run in int64
and mask to 32 bits after every add and rotate, which is the same modular
arithmetic, so the rows are bit-identical to
:func:`repro_torch.core.mds.counter_parity_rows`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .plan import attention_block_range, attention_mma_plan

__all__ = ["matmul_ref", "coded_matvec_ref", "coded_matvec_batch_ref",
           "mds_encode_ref", "threefry2x32_ref", "counter_parity_rows_ref",
           "parity_contract_ref", "gen_parity_ref", "wkv6_chunk_ref",
           "wkv6_chunked_ref", "wkv6_subchunk_ref", "wkv6_seq_ref",
           "wkv6_bwd_ref", "wkv6_bwd_chunked_ref", "attention_ref",
           "attention_mma_ref", "attention_bwd_ref"]

_M32 = 0xFFFFFFFF
_TF_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TF_PARITY = 0x1BD11BDA
#: entries per chunk of the plain counter derivation (bounds the int64
#: temporaries at ~128 MB each)
_CHUNK = 1 << 24


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation, in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _working_type(*ts: torch.Tensor) -> torch.dtype:
    """float64 if any operand is float64, else float32."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) \
        else torch.float32


def coded_matvec_ref(a_tilde: torch.Tensor, x: torch.Tensor, *,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = Ã @ x for x of shape (S,) or (S, B), accumulated in
    ``out_dtype`` (default: the operands' working type) and returned in
    ``out_dtype`` (default: x's dtype)."""
    acc = out_dtype or _working_type(a_tilde, x)
    return torch.matmul(a_tilde.to(acc), x.to(acc)).to(out_dtype or x.dtype)


def coded_matvec_batch_ref(a_tilde: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Per-task y_b = Ã_b @ x_b for Ã (B, L, S) and x (B, S) or (B, S, C):
    a loop over the task axis."""
    return torch.stack([coded_matvec_ref(a_tilde[b], x[b])
                        for b in range(a_tilde.shape[0])])


def mds_encode_ref(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Ã = G @ A accumulated in A's working type (float32, or float64 for
    float64 A), in A's dtype.  ``g`` (L̃, L) or (B, L̃, L), ``a`` (L, S) or
    (B, L, S)."""
    acc = _working_type(a)
    return torch.matmul(g.to(acc), a.to(acc)).to(a.dtype)


def threefry2x32_ref(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor):
    """20-round threefry2x32 on int64 tensors holding uint32 values."""
    ks2 = (k0 ^ k1 ^ _TF_PARITY) & _M32
    sched = (k1, ks2, k0)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for d in range(5):
        for r in _TF_ROT[d % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + sched[d % 3]) & _M32
        x1 = (x1 + sched[(d + 1) % 3] + d + 1) & _M32
    return x0, x1


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def counter_parity_rows_ref(key, scale: float, ctrs: torch.Tensor,
                            cols: torch.Tensor) -> torch.Tensor:
    """R[ctrs][:, cols] float32 — ``ctrs`` (n,) and ``cols`` (m,) integer
    tensors holding uint32 values; ``scale`` the float32 ``sqrt(3/L)``."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ctrs = ctrs.to(torch.int64)
    cols = cols.to(torch.int64)
    n, m = ctrs.numel(), cols.numel()
    out = torch.empty((n, m), dtype=torch.float32, device=ctrs.device)
    step = max(1, _CHUNK // max(m, 1))
    c1a = (cols * 2) & _M32
    c1b = (c1a + 1) & _M32
    for i in range(0, n, step):
        c0 = ctrs[i:i + step, None]
        a0, a1 = threefry2x32_ref(k0, k1, c0, c1a[None, :])
        b0, b1 = threefry2x32_ref(k0, k1, c0, c1b[None, :])
        g = (_uniform24(a0) + _uniform24(a1)) \
            + (_uniform24(b0) + _uniform24(b1)) - 2.0
        out[i:i + step] = g * scale
    return out


def parity_contract_ref(key, scale: float, ctrs: torch.Tensor,
                        cols: torch.Tensor, z: torch.Tensor, *,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """``R[ctrs][:, cols] @ z`` (n, C) in z's dtype, which is also the
    accumulation type: R is derived in row chunks of about ``chunk``
    entries (default ``_CHUNK``; never all of it at once), each float32
    chunk widened to z's dtype and multiplied."""
    n, m = ctrs.numel(), cols.numel()
    out = torch.empty((n, z.shape[1]), dtype=z.dtype, device=z.device)
    step = max(1, (chunk or _CHUNK) // max(m, 1))
    for i in range(0, n, step):
        r = counter_parity_rows_ref(key, scale, ctrs[i:i + step], cols)
        out[i:i + step] = r.to(z.dtype) @ z
    return out


def gen_parity_ref(key, scale: float, ctrs: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Generated-parity products ``R_gen[ctrs] @ (W @ x)`` (n, C) in
    ``out_dtype``, which is also the accumulation type of both products."""
    wx = torch.matmul(w.to(out_dtype), x.to(out_dtype))
    return parity_contract_ref(key, scale, ctrs,
                               torch.arange(w.shape[0], device=w.device), wx)


def wkv6_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sequential RWKV-6 WKV oracle, float32, in v's dtype.

    r, k, w (..., T, K); v (..., T, V); u broadcastable to (..., K) —
    the reference's (T, K) with a shared (K,) ``u`` is the case of no
    leading axes.  From S_0 = 0, one step at a time:

        o_t = r_tᵀ (S_t + (u ⊙ k_t) v_tᵀ),   S_{t+1} = diag(w_t) S_t + k_t v_tᵀ
    """
    dtype = v.dtype
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    S = r.new_zeros(r.shape[:-2] + (r.shape[-1], v.shape[-1]))
    out = []
    for t in range(r.shape[-2]):
        kv = k[..., t, :, None] * v[..., t, None, :]
        out.append(((S + u[..., :, None] * kv)
                    * r[..., t, :, None]).sum(dim=-2))
        S = w[..., t, :, None] * S + kv
    return torch.stack(out, dim=-2).to(dtype)


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     state: Optional[torch.Tensor] = None, chunk: int = 64):
    """Chunk-parallel RWKV-6 WKV — the port of
    ``repro.models.rwkv.wkv6_chunked``, with an optional initial state.

    r, k, w (B, H, T, K); v (B, H, T, V); u (H, K); ``state`` (B, H, K, V)
    or None for zeros.  float32 math; T is padded to the chunk with
    w = 1.  Returns (out (B, H, T, V) in v's dtype, final state (B, H, K,
    V) float32).  The decays telescope through ``exp(-cumsum(log w))``,
    which overflows float32 once a chunk's mean ``log w`` falls below
    about -1.39 (w < 0.25 at chunk 64); :func:`wkv6_chunk_ref` holds at
    any decay.
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    pad = (-T) % chunk
    if pad:
        r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    nc = r.shape[2] // chunk
    u = u.float()[None, :, None, :]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = (t[:, :, sl].float() for t in (r, k, v, w))
        lw = torch.log(torch.clamp(wc, min=1e-12))
        lc = torch.cumsum(lw, dim=2)
        lc_prev = lc - lw
        r_dec = rc * torch.exp(lc_prev)
        k_grow = kc * torch.exp(-lc)
        p = torch.einsum("bhtk,bhsk->bhts", r_dec, k_grow)
        p = torch.where(causal, p, torch.zeros((), device=p.device))
        o = torch.einsum("bhts,bhsv->bhtv", p, vc)
        bonus = torch.einsum("bhtk,bhtk->bht", rc * u, kc)
        o = o + bonus[..., None] * vc
        o = o + torch.einsum("bhtk,bhkv->bhtv", r_dec, S)
        lc_last = lc[:, :, -1]
        k_carry = kc * torch.exp(lc_last[:, :, None, :] - lc)
        S = (torch.exp(lc_last)[..., None] * S
             + torch.einsum("bhtk,bhtv->bhkv", k_carry, vc))
        outs.append(o)
    out = torch.cat(outs, dim=2)[:, :, :T]
    return out.to(v.dtype), S


def _block_products(w: torch.Tensor, L: int):
    """Exclusive prefix and suffix products of ``w`` (..., C, K) inside
    each aligned block of L steps along the time axis: (Π_{start<=τ<t} w,
    Π_{t<τ<=end} w)."""
    *lead, C, K = w.shape
    b = w.reshape(*lead, C // L, L, K)
    one = torch.ones_like(b[..., :1, :])
    pre = torch.cat([one, torch.cumprod(b[..., :-1, :], dim=-2)], dim=-2)
    suf = torch.cat([torch.flip(torch.cumprod(torch.flip(b[..., 1:, :], [-2]),
                                              dim=-2), [-2]), one], dim=-2)
    return pre.reshape(w.shape), suf.reshape(w.shape)


def wkv6_subchunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor,
                      state: Optional[torch.Tensor] = None, chunk: int = 16):
    """The chunked form ``csrc/wkv6.cu`` runs for T > 1, in float32 torch
    (for tests: nothing on the main path calls it).

    r, k, w (B, H, T, K); v (B, H, T, V); u (H, K); ``state`` (B, H, K, V)
    or None for zeros.  Returns (out (B, H, T, V) in v's dtype, final state
    (B, H, K, V) float32), as :func:`wkv6_chunked_ref` does.  Decays are
    clamped to w >= 1e-12 (the reference's clamp before its log), and T is
    padded to the chunk (a power of two) with w = 1.  Per chunk: the
    carry-in ``(r ⊙ F) S`` and the state step ``diag(Π w) S + (k ⊙ G)ᵀ v``
    (F, G the exclusive prefix and suffix products over the chunk); the
    strict-causal term A[t, s] = Σ_k r_t k_s Π_{s<τ<t} w_τ as one product
    per level L = C/2, ..., 1: the pairs whose steps first fall into
    different halves of an aligned 2L-block factor through the last step
    of s's half, as (r ⊙ prefix within t's half)(k ⊙ suffix within s's
    half)ᵀ.  Every factor is a product of decays, each <= 1: no growth
    factor e^{-Σ log w}, so it holds at any decay.
    """
    if chunk & (chunk - 1) or chunk < 2:
        raise ValueError(f"wkv6_subchunk_ref: chunk {chunk} is not a power "
                         f"of two")
    B, H, T, K = r.shape
    V, dtype = v.shape[-1], v.dtype
    pad = (-T) % chunk
    r, k, v = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
               for t in (r, k, v))
    w = torch.nn.functional.pad(torch.clamp(w.float(), min=1e-12),
                                (0, 0, 0, pad), value=1.0)
    u = u.float()[None, :, None, :]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    t_idx = torch.arange(chunk, device=r.device)
    diff = t_idx[:, None] ^ t_idx[None, :]
    lower = t_idx[:, None] > t_idx[None, :]
    outs = []
    for c in range(r.shape[2] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = (t[:, :, sl] for t in (r, k, v, w))
        fwd, bwd = _block_products(wc, chunk)
        o = torch.einsum("bhtk,bhkv->bhtv", rc * fwd, S)
        A = torch.zeros(rc.shape[:3] + (chunk,), dtype=torch.float32,
                        device=r.device)
        L = chunk // 2
        while L >= 1:
            f, g = _block_products(wc, L)
            level = lower & (diff >= L) & (diff < 2 * L)
            A = A + torch.where(level, torch.einsum(
                "bhtk,bhsk->bhts", rc * f, kc * g), A.new_zeros(()))
            L //= 2
        bonus = torch.einsum("bhtk,bhtk->bht", rc * u, kc)
        o = o + torch.einsum("bhts,bhsv->bhtv", A, vc) + bonus[..., None] * vc
        S = (torch.prod(wc, dim=2)[..., None] * S
             + torch.einsum("bhtk,bhtv->bhkv", kc * bwd, vc))
        outs.append(o)
    out = torch.cat(outs, dim=2)[:, :, :T]
    return out.to(dtype), S


def wkv6_seq_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """The sequential recurrence in the inputs' own type, differentiable
    (for tests and the card's gates: the oracle whose float64 autograd
    the backward is held against; nothing on the main path calls it).

    r, k, w (B, H, T, K); v (B, H, T, V); u (H, K); ``state`` (B, H, K, V)
    or None for zeros.  Decays are clamped to w >= 1e-12, as the
    reference's log clamps them, so a decay below the clamp gets no
    gradient.  Returns (out (B, H, T, V), final state (B, H, K, V)), both
    in the type of r.
    """
    wc = torch.clamp(w, min=1e-12)
    uu = u.to(r.dtype)[None, :, :, None]
    S = (r.new_zeros(r.shape[:2] + (r.shape[-1], v.shape[-1]))
         if state is None else state.to(r.dtype))
    out = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        out.append(((S + uu * kv) * r[:, :, t, :, None]).sum(dim=-2))
        S = wc[:, :, t, :, None] * S + kv
    if not out:
        return v.new_zeros(v.shape).to(r.dtype), S
    return torch.stack(out, dim=2), S


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 state: Optional[torch.Tensor], do: torch.Tensor,
                 dS_T: Optional[torch.Tensor] = None):
    """The backward of the WKV recurrence, the plain twin of
    ``csrc/wkv6_bwd.cu``, in float32.

    r, k, w (B, H, T, K); v and the output's cotangent ``do`` (B, H, T,
    V); u (H, K); ``state`` S_0 and the final state's cotangent ``dS_T``
    (B, H, K, V), each None for zeros.  With the decays clamped to
    w >= 1e-12, D_T = dS_T and D_t = diag(w_t) D_{t+1} + r_t do_tᵀ:

        dr_t = S_t do_t + u ⊙ k_t (v_t · do_t)
        dk_t = D_{t+1} v_t + u ⊙ r_t (v_t · do_t)
        dv_t = D_{t+1}ᵀ k_t + (r_t · (u ⊙ k_t)) do_t
        dw_t = Σ_v S_t ⊙ D_{t+1}  (0 where w_t < 1e-12)
        du_h = Σ_{b,t} r_t ⊙ k_t (v_t · do_t),   dS_0 = D_0

    The states S_t and D_{t+1} of every step are kept (two (B, H, T, K, V)
    float32 tensors), so dw is the direct form at any decay.  Returns (dr,
    dk, dv, dw) in the type of r, du (H, K) and dS_0 (B, H, K, V) float32.
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    dtype = r.dtype
    rf, kf, vf, dof = (t.float() for t in (r, k, v, do))
    wf = w.float()
    wc = torch.clamp(wf, min=1e-12)
    uf = u.float()[None, :, None, :]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    Ss = torch.empty((B, H, T, K, V), dtype=torch.float32, device=r.device)
    for t in range(T):
        Ss[:, :, t] = S
        S = wc[:, :, t, :, None] * S + kf[:, :, t, :, None] \
            * vf[:, :, t, None, :]
    D = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if dS_T is None else dS_T.float())
    Ds = torch.empty_like(Ss)
    for t in reversed(range(T)):
        Ds[:, :, t] = D
        D = wc[:, :, t, :, None] * D + rf[:, :, t, :, None] \
            * dof[:, :, t, None, :]
    vdo = (vf * dof).sum(-1, keepdim=True)
    dr = torch.einsum("bhtkv,bhtv->bhtk", Ss, dof) + uf * kf * vdo
    dk = torch.einsum("bhtkv,bhtv->bhtk", Ds, vf) + uf * rf * vdo
    dv = (torch.einsum("bhtkv,bhtk->bhtv", Ds, kf)
          + (rf * uf * kf).sum(-1, keepdim=True) * dof)
    dw = torch.where(wf >= 1e-12, (Ss * Ds).sum(-1), 0.0)
    du = (rf * kf * vdo).sum(dim=(0, 2))
    return (dr.to(dtype), dk.to(dtype), dv.to(dtype), dw.to(dtype), du, D)


def wkv6_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor,
                         state: Optional[torch.Tensor], do: torch.Tensor,
                         dS_T: Optional[torch.Tensor] = None,
                         chunk: int = 16):
    """The two-level form ``csrc/wkv6_bwd.cu`` runs, in float32 torch (for
    tests: nothing on the main path calls it).  Arguments and results as
    :func:`wkv6_bwd_ref`; T is padded to the chunk with r = k = v = do = 0
    and w = 1, which leave both states as they are.

    Level 1, sequential over chunks: the state at every chunk start in
    forward time and the cotangent state at every chunk end in reverse
    time, each step a chunk's product

        S_{c+1} = diag(Π w) S_c + (K ⊙ G)ᵀ V,
        D_c     = diag(Π w) D_{c+1} + (R ⊙ F)ᵀ dO,

    with F_t = Π_{τ<t} w_τ and G_t = Π_{τ>t} w_τ inside the chunk.  Level
    2, every chunk at once, from S_c and D_e = D_{c+1}: with B[t, s] =
    do_t · v_s, Q[t, s] = Π_{s<τ<t} w_τ (t > s) and A[t, s] = Σ_k r_t k_s
    Q[t, s],

        dr_t = F_t ⊙ S_c do_t + Σ_{s<t} B[t, s] Q[t, s] ⊙ k_s + bonus
        dk_t = G_t ⊙ D_e v_t  + Σ_{s>t} B[s, t] Q[s, t] ⊙ r_s + bonus
        dv_t = D_eᵀ (G_t ⊙ k_t) + Σ_{s>t} A[s, t] do_s     + bonus

    and dw in the direct form: S_t stepped forward from S_c and D_{t+1}
    backward from D_e, dw_t = Σ_v S_t ⊙ D_{t+1}.  Every decay factor is a
    product of clamped decays, each <= 1: no growth factor e^{-Σ log w}
    and no division, so it holds at any decay.
    """
    B, H, T, K = r.shape
    V, dtype = v.shape[-1], r.dtype
    pad = (-T) % chunk
    rf, kf, vf, dof = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
                       for t in (r, k, v, do))
    wc = torch.nn.functional.pad(torch.clamp(w.float(), min=1e-12),
                                 (0, 0, 0, pad), value=1.0)
    nc = rf.shape[2] // chunk
    fwd, bwd = _block_products(wc, chunk)
    rc, kc, vc, dc, wcc, fc, gc = (
        t.reshape(B, H, nc, chunk, t.shape[-1])
        for t in (rf, kf, vf, dof, wc, fwd, bwd))
    tot = torch.prod(wcc, dim=3)[..., None]
    zeros = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    # level 1: S_c at every chunk start, D_{c+1} at every chunk end
    S = zeros if state is None else state.float()
    Sc = []
    for c in range(nc):
        Sc.append(S)
        S = tot[:, :, c] * S + torch.einsum("bhtk,bhtv->bhkv",
                                            kc[:, :, c] * gc[:, :, c],
                                            vc[:, :, c])
    D = zeros if dS_T is None else dS_T.float()
    Dc = [zeros] * nc
    for c in reversed(range(nc)):
        Dc[c] = D
        D = tot[:, :, c] * D + torch.einsum("bhtk,bhtv->bhkv",
                                            rc[:, :, c] * fc[:, :, c],
                                            dc[:, :, c])
    dS_0 = D
    shape = (B, H, nc, chunk)
    dw = torch.empty(shape + (K,), device=r.device)
    if nc:
        Sc, De = torch.stack(Sc, dim=2), torch.stack(Dc, dim=2)
        # level 2, dr dk dv: the boundary states' products and the pairs
        # inside the chunk
        Q = torch.zeros(shape + (chunk, K), device=r.device)
        for t in range(chunk):
            run = torch.ones_like(wcc[..., 0, :])
            for s in reversed(range(t)):
                Q[..., t, s, :] = run
                run = run * wcc[..., s, :]
        Bm = torch.einsum("bhctv,bhcsv->bhcts", dc, vc)
        A = torch.einsum("bhctk,bhcsk,bhctsk->bhcts", rc, kc, Q)
        dr = (fc * torch.einsum("bhckv,bhctv->bhctk", Sc, dc)
              + torch.einsum("bhcts,bhctsk,bhcsk->bhctk", Bm, Q, kc))
        dk = (gc * torch.einsum("bhckv,bhctv->bhctk", De, vc)
              + torch.einsum("bhcst,bhcstk,bhcsk->bhctk", Bm, Q, rc))
        dv = (torch.einsum("bhctk,bhckv->bhctv", kc * gc, De)
              + torch.einsum("bhcst,bhcsv->bhctv", A, dc))
        # level 2, dw: each chunk's steps from its two boundary states
        S = Sc
        hist = []
        for s in range(chunk):
            hist.append(S)
            S = wcc[..., s, :, None] * S \
                + kc[..., s, :, None] * vc[..., s, None, :]
        D = De
        for s in reversed(range(chunk)):
            dw[..., s, :] = (hist[s] * D).sum(-1)
            D = wcc[..., s, :, None] * D \
                + rc[..., s, :, None] * dc[..., s, None, :]
    else:
        dr = dk = torch.empty(shape + (K,), device=r.device)
        dv = torch.empty(shape + (V,), device=r.device)
    dr, dk, dw, dv = (t.reshape(B, H, nc * chunk, t.shape[-1])[:, :, :T]
                      for t in (dr, dk, dw, dv))
    rf, kf, vf, dof = (t[:, :, :T] for t in (rf, kf, vf, dof))
    uf = u.float()[None, :, None, :]
    vdo = (vf * dof).sum(-1, keepdim=True)
    dr = dr + uf * kf * vdo
    dk = dk + uf * rf * vdo
    dv = dv + (rf * uf * kf).sum(-1, keepdim=True) * dof
    dw = torch.where(w.float() >= 1e-12, dw, 0.0)
    du = (rf * kf * vdo).sum(dim=(0, 2))
    return (dr.to(dtype), dk.to(dtype), dv.to(dtype), dw.to(dtype), du,
            dS_0)


def _kv_limit(kv_valid, Tk: int, pad_k: int, device):
    """The reference's ``kv_valid`` as a (B, 1, 1, 1, 1) or scalar int64
    tensor (None when no key is masked by it): clamped to Tk when the keys
    were padded to whole blocks, as the reference does."""
    if pad_k:
        kv_valid = torch.clamp(torch.as_tensor(
            Tk if kv_valid is None else kv_valid, device=device), max=Tk)
    if kv_valid is None:
        return None
    kv = torch.as_tensor(kv_valid, device=device).to(torch.int64)
    return kv.reshape(-1, 1, 1, 1, 1) if kv.dim() else kv


def _tile_mask(q_pos, k_pos, causal, window, kv):
    """The reference's ``_attn_block`` mask, (bq, bk) or (B, 1, 1, bq, bk)
    with a per-row ``kv`` limit."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    mask = mask[None, None, None]
    if kv is not None:
        mask = mask & (kp < kv)
    return mask


def _key_block(j: int, bk: int, n: int) -> slice:
    """The keys ``jax.lax.dynamic_slice_in_dim(t, j * bk, bk)`` takes from
    n padded keys: the start clamped so that the block lies inside them."""
    start = min(j * bk, n - bk)
    return slice(start, start + bk)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, kv_valid=None, block_q: int = 512,
                  block_k: int = 512, scale: Optional[float] = None):
    """Blockwise softmax attention, the port of the reference's
    ``repro.models.attention.flash_attention`` line for line, and the plain
    twin of ``csrc/attention.cu``.

    q (B, Tq, Hq, D); k, v (B, Tk, Hkv, D / Dv), Hq a multiple of Hkv (GQA);
    ``q_offset`` the absolute position of q[0]; ``kv_valid`` a scalar or
    (B,) count of valid keys.  The query axis is cut into blocks of
    ``block_q``; each block scans only the key blocks of ``block_k`` that
    its causal / window masks leave a pair in, with a running max,
    numerator and denominator in float32.  One difference: a row whose
    running max is still -inf (every key seen so far masked) takes its
    correction and its probabilities as 0, where the reference's
    exp(-inf + inf) gives NaN rows under a window.  Returns (out (B, Tq, Hq,
    Dv) in q's type, the rows' log-sum-exp (B, Hq, Tq) float32, -inf for a
    row that sees no key)."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qh = q.reshape(B, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    nq, nk = -(-Tq // bq), -(-Tk // bk)
    pad_q, pad_k = nq * bq - Tq, nk * bk - Tk
    if pad_q:
        qh = torch.nn.functional.pad(qh, (0, 0, 0, pad_q))
    if pad_k:
        kh = torch.nn.functional.pad(kh, (0, 0, 0, pad_k))
        vh = torch.nn.functional.pad(vh, (0, 0, 0, pad_k))
    kv = _kv_limit(kv_valid, Tk, pad_k, q.device)
    out_blocks, lse_blocks = [], []
    for i in range(nq):
        q_blk = qh[:, :, :, i * bq:(i + 1) * bq]
        q_pos = q_offset + i * bq + torch.arange(bq, device=q.device)
        j_lo, steps = attention_block_range(i, bq, bk, nk, causal, window,
                                             q_offset)
        m = torch.full((B, Hkv, G, bq), -math.inf, device=q.device)
        num = torch.zeros((B, Hkv, G, bq, Dv), device=q.device)
        den = torch.zeros((B, Hkv, G, bq), device=q.device)
        for j in range(j_lo, j_lo + steps):
            keys = _key_block(j, bk, kh.shape[2])
            k_blk, v_blk = kh[:, :, keys], vh[:, :, keys]
            k_pos = j * bk + torch.arange(bk, device=q.device)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
            s = torch.where(_tile_mask(q_pos, k_pos, causal, window, kv), s,
                            -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row with nothing seen yet: corr and p are 0, not NaN
            m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
            corr = torch.exp(m - m_use)
            p = torch.exp(s - m_use[..., None])
            num = num * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, v_blk)
            den = den * corr + p.sum(dim=-1)
            m = m_new
        out_blocks.append(num / torch.clamp(den, min=1e-30)[..., None])
        lse_blocks.append(torch.where(
            den > 0, torch.where(torch.isneginf(m), 0.0, m)
            + torch.log(torch.clamp(den, min=1e-30)), -math.inf))
    out = torch.cat(out_blocks, dim=3)[:, :, :, :Tq]
    lse = torch.cat(lse_blocks, dim=3)[:, :, :, :Tq]
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, Dv).to(q.dtype),
            lse.reshape(B, Hq, Tq).detach())


def _bf16_cut(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` cut to bf16 (its top 16 bits: rounded toward zero),
    as float32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def attention_mma_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, kv_valid=None,
                      scale: Optional[float] = None,
                      block_k: Optional[int] = None, block_q: int = 1024,
                      p_parts: int = 2):
    """The plain twin of ``csrc/attention_mma.cu``, the tensor-core forward
    of bf16 attention: :func:`attention_ref`'s function (same layouts,
    masks, rows that see no key, log-sum-exp) in that kernel's arithmetic.
    Keys go in steps of ``block_k`` (the plan's ``bk`` by default) aligned
    to its multiples, over the range a block of ``block_q`` query
    positions can see (a step a row cannot see leaves it exactly as it
    was, so the query blocks change nothing); scores are float32 sums of
    the inputs' products, scaled into log2 units by ``scale * log2(e)``
    rounded to float32; the running max, denominator and numerator are
    float32, the exponentials exp2; P enters P V as the sum of two bf16
    parts cut from its bits, hi = P's top 16 bits and lo = the top 16 of
    P - hi (``p_parts`` 1: P rounded to one bf16 part instead, which
    misses the kernel's gate at rows that see few keys; the denominator
    sums P itself).  Returns (out (B, Tq, Hq, Dv) in q's
    type, lse (B, Hq, Tq) float32, ln 2 (m + log2 l), -inf for a row that
    sees no key).  Only the CPU tests and ``chip_smoke.py`` call it."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, Dv = v.shape
    G = Hq // Hkv
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bk = block_k or attention_mma_plan(D, Dv, G).bk
    sl2 = float(torch.tensor(scale * 1.4426950408889634,
                             dtype=torch.float32))
    qh = q.reshape(B, Tq, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    kv = _kv_limit(kv_valid, Tk, 0, dev)
    out = torch.zeros((B, Hkv, G, Tq, Dv), device=dev)
    lse = torch.full((B, Hkv, G, Tq), -math.inf, device=dev)
    for i0 in range(0, Tq, block_q):
        n = min(block_q, Tq - i0)
        q_blk = qh[:, :, :, i0:i0 + n]
        q_pos = q_offset + i0 + torch.arange(n, device=dev)
        hi = min(Tk, q_offset + i0 + n) if causal else Tk
        lo = 0 if window is None else max(0, q_offset + i0 - window + 1)
        m = torch.full((B, Hkv, G, n), -math.inf, device=dev)
        den = torch.zeros((B, Hkv, G, n), device=dev)
        num = torch.zeros((B, Hkv, G, n, Dv), device=dev)
        for k0 in range(lo // bk * bk, hi if hi > lo else 0, bk):
            keys = slice(k0, min(k0 + bk, Tk))
            k_pos = torch.arange(keys.start, keys.stop, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, kh[:, :, keys]) * sl2
            s = torch.where(_tile_mask(q_pos, k_pos, causal, window, kv), s,
                            -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row with nothing seen yet: corr and p are 0, not NaN
            m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
            corr = torch.exp2(m - m_use)
            p = torch.exp2(s - m_use[..., None])
            den = den * corr + p.sum(dim=-1)
            hi = _bf16_cut(p) if p_parts == 2 else p.bfloat16().float()
            num = num * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", hi, vh[:, :, keys])
            if p_parts == 2:
                num = num + torch.einsum("bhgqk,bhkd->bhgqd",
                                         _bf16_cut(p - hi), vh[:, :, keys])
            m = m_new
        out[:, :, :, i0:i0 + n] = num / torch.clamp(den, min=1e-30)[..., None]
        lse[:, :, :, i0:i0 + n] = torch.where(
            den > 0, (torch.where(torch.isneginf(m), 0.0, m)
                      + torch.log2(torch.clamp(den, min=1e-30))) * math.log(2),
            -math.inf)
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, Dv).to(q.dtype),
            lse.reshape(B, Hq, Tq))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, kv_valid=None, block_q: int = 512,
                      block_k: int = 512, scale: Optional[float] = None):
    """The gradient of :func:`attention_ref`, the plain twin of
    ``csrc/attention_bwd.cu``, over the same block ranges in float32.

    From the forward's output ``out`` and row log-sum-exp ``lse`` and the
    output's cotangent ``do`` (B, Tq, Hq, Dv): D_i = Σ dO_i ⊙ O_i, then for
    every visited (query, key) pair P = exp(s - lse) (0 where masked or
    where the row sees no key), dV += Pᵀ dO, dS = P ⊙ (dO Vᵀ - D_i), dQ +=
    scale dS K, dK += scale dSᵀ Q.  Returns (dq, dk, dv) in the input
    types."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    def heads(t):
        return t.reshape(B, Tq, Hkv, G, -1).permute(0, 2, 3, 1, 4).float()
    qh, oh, doh = heads(q), heads(out), heads(do)
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    di = (doh * oh).sum(-1)                               # (B, Hkv, G, Tq)
    lh = lse.reshape(B, Hkv, G, Tq).float()
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    nq, nk = -(-Tq // bq), -(-Tk // bk)
    pad_q, pad_k = nq * bq - Tq, nk * bk - Tk
    pad = torch.nn.functional.pad
    if pad_q:
        qh, doh = pad(qh, (0, 0, 0, pad_q)), pad(doh, (0, 0, 0, pad_q))
        di, lh = pad(di, (0, pad_q)), pad(lh, (0, pad_q), value=-math.inf)
    if pad_k:
        kh, vh = pad(kh, (0, 0, 0, pad_k)), pad(vh, (0, 0, 0, pad_k))
    kv = _kv_limit(kv_valid, Tk, pad_k, q.device)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for i in range(nq):
        rows = slice(i * bq, (i + 1) * bq)
        q_blk, do_blk = qh[:, :, :, rows], doh[:, :, :, rows]
        l_blk, d_blk = lh[:, :, :, rows, None], di[:, :, :, rows, None]
        live = ~torch.isneginf(l_blk)
        l_use = torch.where(live, l_blk, 0.0)
        q_pos = q_offset + i * bq + torch.arange(bq, device=q.device)
        j_lo, steps = attention_block_range(i, bq, bk, nk, causal, window,
                                             q_offset)
        for j in range(j_lo, j_lo + steps):
            keys = _key_block(j, bk, kh.shape[2])
            k_blk, v_blk = kh[:, :, keys], vh[:, :, keys]
            k_pos = j * bk + torch.arange(bk, device=q.device)
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
            mask = _tile_mask(q_pos, k_pos, causal, window, kv) & live
            p = torch.where(mask, torch.exp(s - l_use), 0.0)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_blk, v_blk)
            ds = p * (dp - d_blk)
            dq[:, :, :, rows] += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                              k_blk) * scale
            dk[:, :, keys] += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                           q_blk) * scale
            dv[:, :, keys] += torch.einsum("bhgqk,bhgqd->bhkd", p, do_blk)
    dq = dq[:, :, :, :Tq].permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, D)
    dk = dk[:, :, :Tk].permute(0, 2, 1, 3)
    dv = dv[:, :, :Tk].permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
