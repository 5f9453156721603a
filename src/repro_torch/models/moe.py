"""Mixture-of-Experts layer with capacity-bounded expert-choice dispatch —
the port of the single-device path of ``repro.models.moe``.

Dispatch: tokens pick their top-k experts (token choice); each expert then
keeps its top-C tokens by router probability (capacity dropping by lowest
affinity, not arrival order).  The router runs, and is stored, in float32.
Both selections are stable descending sorts, which order ties (the zeros
of tokens that did not pick an expert) by index as ``lax.top_k`` does.
The combine sums each token's routed outputs in ascending expert order,
the order in which the reference's scatter-add applies them; it gathers
instead of scattering, because ``index_add_`` on the card accumulates
through atomics in no fixed order, and a bf16 sum in another order can
flip a later layer's router choice from one run to the next.  Shared
experts (DeepSeek) are added on every token after it.

The reference's expert-parallel paths (``shard_map`` with all-to-alls over
a mesh) wait for the port's parallelism; ``apply_moe`` takes no mesh.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig, MoEConfig
from .layers import _normal, einsum

__all__ = ["init_moe", "apply_moe", "moe_capacity"]


def moe_capacity(m: MoEConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * m.top_k / m.num_experts * m.capacity_factor))
    c = max(8, -(-c // 8) * 8)      # pad to a sublane multiple
    return min(c, n_tokens)         # never more slots than tokens


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": _normal(gen, (d, E), torch.float32, device) * s_in,
        "w_in": _normal(gen, (E, d, f), dtype, device) * s_in,
        "w_gate": _normal(gen, (E, d, f), dtype, device) * s_in,
        "w_out": _normal(gen, (E, f, d), dtype, device) * s_out,
    }
    if m.n_shared:
        p["shared_in"] = _normal(gen, (d, m.n_shared * f), dtype,
                                 device) * s_in
        p["shared_gate"] = _normal(gen, (d, m.n_shared * f), dtype,
                                   device) * s_in
        p["shared_out"] = _normal(gen, (m.n_shared * f, d), dtype,
                                  device) * s_out
    return p


def _expert_ffn(w_in, w_gate, w_out, xs):
    """xs: (E, C, d) → (E, C, d), SwiGLU experts."""
    h = torch.bmm(xs, w_in)
    g = torch.bmm(xs, w_gate)
    return torch.bmm(F.silu(g) * h, w_out)


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: ties keep the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """Expert-choice-of-token-choice dispatch tables.

    probs: (T, E) router probabilities.  Returns (idx, weight):
      idx    (E, C) token index each expert processes,
      weight (E, C) combine weight (0 where the slot is empty/dropped)."""
    topv, topi = _top(probs, top_k)                        # (T, k)
    chosen = torch.zeros_like(probs).scatter_(1, topi, topv)
    w, idx = _top(chosen.T, capacity)                      # (E, C)
    return idx, w


def _combine(ys: torch.Tensor, idx: torch.Tensor,
             probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """out[t] = the sum of ys[e, slot of t in e] over the experts e that
    token t chose and that kept it, added in ascending e.  ys: (E, C, d)
    weighted outputs; idx: (E, C) token of each slot (distinct in a row);
    probs: (T, E).  A slot of zero weight adds nothing, as in the
    reference."""
    E, C = idx.shape
    T = probs.shape[0]
    slot = torch.full((E, T), -1, dtype=torch.long, device=ys.device)
    slot.scatter_(1, idx, torch.arange(C, device=ys.device).expand(E, C))
    chosen = _top(probs, top_k)[1].sort(dim=1).values       # (T, k)
    s = slot[chosen, torch.arange(T, device=ys.device)[:, None]]
    got = ys[chosen, s.clamp(min=0)]                        # (T, k, d)
    got = got.masked_fill((s < 0)[..., None], 0)
    out = got[:, 0]
    for j in range(1, top_k):
        out = out + got[:, j]
    return out


def apply_moe(params: dict, x: torch.Tensor, *,
              cfg: ArchConfig) -> torch.Tensor:
    """x: (B, T, d) → (B, T, d), the reference's single-device path."""
    m = cfg.moe
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    cap = moe_capacity(m, xt.shape[0])
    idx, w = _dispatch(probs, m.top_k, cap)                 # (E, C)
    xs = xt[idx.reshape(-1)].reshape(m.num_experts, cap, d)
    ys = _expert_ffn(params["w_in"], params["w_gate"], params["w_out"], xs)
    ys = ys * w[..., None].to(ys.dtype)
    out = _combine(ys, idx, probs, m.top_k)
    if m.n_shared:
        h = einsum("td,df->tf", xt, params["shared_in"])
        g = einsum("td,df->tf", xt, params["shared_gate"])
        out = out + einsum("tf,fd->td", F.silu(g) * h, params["shared_out"])
    return out.reshape(B, T, d)
