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

Under a mesh (``torch.distributed``, DTensor weights) the dispatch runs
in one of the reference's three expert-parallel bodies, each under
``local_map`` on the ranks' local tensors, chosen by the reference's rule:
``ep_full_body`` (experts over the data dims, their hidden width over the
model dim) when asked for and the tokens allow it, else ``ep_moe`` (experts
over the model dim, two all-to-alls) when every model rank gets a token,
else ``ep_small`` (decode-size batches: every model rank runs its experts
on all tokens).  Each combines in ascending expert order as the
single-device path does (``ep_small`` sums its ranks' per-choice outputs
first, so each token's sum is the single-device one).  :data:`EP_CALLS`
counts the bodies run.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig, MoEConfig
from .layers import _normal, einsum

__all__ = ["init_moe", "apply_moe", "moe_capacity", "EP_CALLS"]

#: expert-parallel bodies run, by name (the tests and the smoke run read
#: them to show each path ran)
EP_CALLS: Dict[str, int] = {"ep_small": 0, "ep_moe": 0, "ep_full_body": 0}


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


def _gathered(ys: torch.Tensor, idx: torch.Tensor, probs: torch.Tensor,
              top_k: int, e0: int = 0) -> torch.Tensor:
    """(T, k, d): each token's weighted output from each expert it chose,
    in ascending expert order — zero where that expert dropped it or is
    not among the experts e0 .. e0 + E_loc - 1 that ``ys`` (E_loc, C, d)
    and ``idx`` (E_loc, C) hold; probs: (T, E)."""
    E, C = idx.shape
    T = probs.shape[0]
    slot = torch.full((E, T), -1, dtype=torch.long, device=ys.device)
    slot.scatter_(1, idx, torch.arange(C, device=ys.device).expand(E, C))
    chosen = _top(probs, top_k)[1].sort(dim=1).values - e0  # (T, k)
    mine = (chosen >= 0) & (chosen < E)
    ch = chosen.clamp(0, E - 1)
    s = slot[ch, torch.arange(T, device=ys.device)[:, None]]
    s = s.masked_fill(~mine, -1)
    got = ys[ch, s.clamp(min=0)]                            # (T, k, d)
    return got.masked_fill((s < 0)[..., None], 0)


def _sum_choices(got: torch.Tensor) -> torch.Tensor:
    out = got[:, 0]
    for j in range(1, got.shape[1]):
        out = out + got[:, j]
    return out


def _combine(ys: torch.Tensor, idx: torch.Tensor,
             probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """out[t] = the sum of ys[e, slot of t in e] over the experts e that
    token t chose and that kept it, added in ascending e.  ys: (E, C, d)
    weighted outputs; idx: (E, C) token of each slot (distinct in a row);
    probs: (T, E).  A slot of zero weight adds nothing, as in the
    reference."""
    return _sum_choices(_gathered(ys, idx, probs, top_k))


def _local_moe(m: MoEConfig, xt, router, w_in, w_gate, w_out):
    """The single-device dispatch, expert FFN and combine: xt (T, d)."""
    d = xt.shape[-1]
    probs = torch.softmax(xt.float() @ router, dim=-1)
    cap = moe_capacity(m, xt.shape[0])
    idx, w = _dispatch(probs, m.top_k, cap)                 # (E, C)
    xs = xt[idx.reshape(-1)].reshape(m.num_experts, cap, d)
    ys = _expert_ffn(w_in, w_gate, w_out, xs)
    ys = ys * w[..., None].to(ys.dtype)
    return _combine(ys, idx, probs, m.top_k)


def _ep_apply(m: MoEConfig, xf, params: dict, *, mesh, model_axis: str,
              ep_full: bool, a2a_fp8: bool):
    """The reference's ``shard_map`` of an expert-parallel body over
    ``mesh``: xf (n_tok, d) DTensor → (n_tok, d) DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..parallel import ops as pops
    names = mesh.mesh_dim_names
    E, d = m.num_experts, xf.shape[-1]
    S = mesh.size(names.index(model_axis))
    Eps = E // S
    data_axes = tuple(a for a in names if a != model_axis)
    dp = 1
    for a in data_axes:
        dp *= mesh.size(names.index(a))
    n_tok = xf.shape[0]
    tokens_per_shard = n_tok // max(dp, 1)
    g_model = mesh.get_group(model_axis)
    g_data = pops.group_of(mesh, data_axes) if data_axes else None

    def ep_small(xt, router, w_in, w_gate, w_out):
        # decode-size token counts: tokens replicated over the model dim,
        # each rank runs its local experts on all of them; the ranks' per-
        # choice outputs are summed (each token-choice is nonzero on one
        # rank only), then each token's choices in ascending expert order
        EP_CALLS["ep_small"] += 1
        r = mesh.get_local_rank(model_axis)
        probs = torch.softmax(xt.float() @ router, dim=-1)
        T_loc = xt.shape[0]
        topv, topi = _top(probs, m.top_k)
        chosen = torch.zeros_like(probs).scatter_(1, topi, topv)
        my = chosen[:, r * Eps:(r + 1) * Eps]
        cap = moe_capacity(m, T_loc)
        w, idx = _top(my.T, cap)                            # (Eps, C)
        xs = xt[idx.reshape(-1)].reshape(Eps, cap, d)
        ys = _expert_ffn(w_in, w_gate, w_out, xs)
        ys = ys * w[..., None].to(ys.dtype)
        got = _gathered(ys, idx, probs, m.top_k, e0=r * Eps)
        return _sum_choices(pops.psum(got, g_model))

    def ep_moe(xt, router, w_in, w_gate, w_out):
        # xt (T_loc, d): this data shard's tokens, identical over the
        # model dim; each model rank routes its own chunk of them
        EP_CALLS["ep_moe"] += 1
        r = mesh.get_local_rank(model_axis)
        t_chunk = xt.shape[0] // S
        xt_loc = xt[r * t_chunk:(r + 1) * t_chunk]
        probs = torch.softmax(xt_loc.float() @ router, dim=-1)
        cap = moe_capacity(m, t_chunk)
        idx, w = _dispatch(probs, m.top_k, cap)             # (E, C)
        xs = xt_loc[idx.reshape(-1)].reshape(S, Eps, cap, d)
        # dispatch: each rank receives every source's tokens for its
        # experts, (S sources, Eps, C, d)
        xs = pops.all_to_all(xs, g_model)
        xs = xs.transpose(0, 1).reshape(Eps, S * cap, d)
        ys = _expert_ffn(w_in, w_gate, w_out, xs)
        ys = ys.reshape(Eps, S, cap, d).transpose(0, 1).contiguous()
        ys = pops.all_to_all(ys, g_model)                   # return
        ys = ys.reshape(E, cap, d) * w[..., None].to(ys.dtype)
        out_loc = _combine(ys, idx, probs, m.top_k)
        # reassemble the data shard's tokens over the model dim
        return pops.all_gather(out_loc, g_model)

    def ep_full_body(xt, router, w_in, w_gate, w_out):
        # xt (T_loc, d) identical over the model dim; w_* blocks are
        # (E/dp, d, f/tp): dispatch duplicated over the model ranks, the
        # expert matmuls split f over the model dim
        EP_CALLS["ep_full_body"] += 1
        probs = torch.softmax(xt.float() @ router, dim=-1)
        T_loc = xt.shape[0]
        cap = moe_capacity(m, T_loc)
        idx, w = _dispatch(probs, m.top_k, cap)             # (E, C)
        Edp = E // dp
        xs = xt[idx.reshape(-1)].reshape(dp, Edp, cap, d)
        if a2a_fp8:
            # DeepSeek-V3-style fp8 dispatch (the combine stays in the
            # activations' dtype)
            xs = xs.to(torch.float8_e4m3fn)
        xs = pops.all_to_all(xs, g_data).to(xt.dtype)
        xs = xs.transpose(0, 1).reshape(Edp, dp * cap, d)
        ys = pops.psum(_expert_ffn(w_in, w_gate, w_out, xs), g_model)
        ys = ys.reshape(Edp, dp, cap, d).transpose(0, 1).contiguous()
        ys = pops.all_to_all(ys, g_data)
        ys = ys.reshape(E, cap, d) * w[..., None].to(ys.dtype)
        return _combine(ys, idx, probs, m.top_k)

    def pl(*dims):
        """Placements: tensor dim ``dims[i]`` on mesh dim i (None:
        replicated)."""
        return [Replicate() if x is None else Shard(x) for x in dims]

    model_i = names.index(model_axis)

    def on(model_dim, data_dim):
        return pl(*(model_dim if i == model_i else data_dim
                    for i in range(len(names))))

    use_full = (ep_full and E % dp == 0 and tokens_per_shard >= dp
                and n_tok % dp == 0)
    if use_full:
        body = ep_full_body
        # (E, d, f) in/gate split f on model; (E, f, d) out splits f = dim 1
        w_in_pl, w_out_pl = on(2, 0), on(1, 0)
    else:
        body = ep_moe if tokens_per_shard >= S else ep_small
        w_in_pl = w_out_pl = on(0, None)
    # a batch of one can't shard the token dim at all: replicate
    x_pl = pops.data_placements(
        mesh, model_axis,
        0 if (dp > 1 and n_tok % dp == 0 and n_tok >= dp) else None)
    rep = pl(*([None] * len(names)))
    return local_map(body, out_placements=x_pl,
                     in_placements=(x_pl, rep, w_in_pl, w_in_pl, w_out_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        xf, params["router"], params["w_in"], params["w_gate"],
        params["w_out"])


def apply_moe(params: dict, x: torch.Tensor, *, cfg: ArchConfig,
              mesh=None, model_axis: str = "model", ep_full: bool = False,
              a2a_fp8: bool = False) -> torch.Tensor:
    """x: (B, T, d) → (B, T, d).

    With ``mesh`` (a DeviceMesh holding ``model_axis``) the dispatch runs
    in an expert-parallel body with the expert axis sharded on
    ``model_axis``; without it, the single-device path.  ``ep_full``:
    experts sharded over the data dims and their hidden width over the
    model dim (all-to-alls over the data dims, one sum over the model dim
    for the split-f product); it requires num_experts % dp == 0 and enough
    tokens, else the rule falls back as the reference's does.
    ``a2a_fp8`` sends ``ep_full``'s dispatch payload in float8_e4m3fn."""
    m = cfg.moe
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    if mesh is None or model_axis not in mesh.mesh_dim_names:
        out = _local_moe(m, xf, params["router"], params["w_in"],
                         params["w_gate"], params["w_out"])
    else:
        out = _ep_apply(m, xf, params, mesh=mesh, model_axis=model_axis,
                        ep_full=ep_full, a2a_fp8=a2a_fp8)
    if m.n_shared:
        h = einsum("td,df->tf", xf, params["shared_in"])
        g = einsum("td,df->tf", xf, params["shared_gate"])
        out = out + einsum("tf,fd->td", F.silu(g) * h, params["shared_out"])
    return out.reshape(B, T, d)
