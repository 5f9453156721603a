"""Adafactor (factored second moment) — the port of
``repro.optim.adafactor``: O(n+m) state per (n, m) matrix instead of
O(nm).  The NamedTuples keep the reference's field order, so a
checkpoint's leaf order matches the reference's."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import _tree
from .adamw import _device

__all__ = ["adafactor_init", "adafactor_update", "AdafactorState"]


class _Factored(NamedTuple):
    row: torch.Tensor
    col: torch.Tensor


class AdafactorState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the parameters' device
    second: Any          # per-leaf: _Factored for >=2D, full tensor otherwise


def _is_factored(p) -> bool:
    return p.dim() >= 2


def _is_state(t) -> bool:
    return isinstance(t, _Factored)


def adafactor_init(params) -> AdafactorState:
    def init(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _is_factored(p):
            return _Factored(row=torch.zeros(p.shape[:-1], **z),
                             col=torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             **z))
        return torch.zeros(p.shape, **z)
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        second=_tree.map(init, params))


def adafactor_update(params, grads, state: AdafactorState, *, lr,
                     decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0):
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    beta = 1.0 - step.to(torch.float32) ** (-decay)

    def upd(p, g, s):
        gf = g.float()
        g2 = gf.square() + eps
        if isinstance(s, _Factored):
            row = beta * s.row + (1 - beta) * g2.mean(dim=-1)
            col = beta * s.col + (1 - beta) * g2.mean(dim=-2)
            row_mean = row.mean(dim=-1, keepdim=True)
            v = (row / torch.clamp(row_mean, min=eps))[..., None] \
                * col[..., None, :]
            new_s = _Factored(row=row, col=col)
        else:
            v = beta * s + (1 - beta) * g2
            new_s = v
        u = gf / torch.sqrt(torch.clamp(v, min=eps))
        rms_u = torch.sqrt(u.square().mean() + eps)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p_new = p.float() - lr_t * u
        return p_new.to(p.dtype), new_s

    # the state tree is the parameter tree with a _Factored or a tensor
    # at each leaf
    p_leaves, skeleton = _tree.flatten(params)
    s_leaves = _tree.leaves(state.second, is_leaf=_is_state)
    out = [upd(p, g, s) for p, g, s in zip(p_leaves, _tree.leaves(grads),
                                           s_leaves)]
    return (_tree.unflatten(skeleton, [o[0] for o in out]),
            AdafactorState(step=step, second=_tree.unflatten(
                skeleton, [o[1] for o in out])))
