"""AdamW with optional low-precision moments — the port of
``repro.optim.adamw``.

The numerics are the reference's: the clip norm is a float32 sum over the
leaves in ``jax.tree`` order (:mod:`repro_torch._tree`), the clip scale
is cast to each gradient's dtype before the multiply, ``b1 ** step`` is
float32, the update runs in float32 and the moments are stored in their
own dtype (the parameter's by default, bfloat16 at full width).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .. import _tree

__all__ = ["OptState", "adamw_init", "adamw_update"]


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


def _device(params) -> torch.device:
    lv = _tree.leaves(params)
    return lv[0].device if lv else torch.device("cpu")


def adamw_init(params, state_dtype: Optional[str] = None) -> OptState:
    def zeros_like(p):
        dt = getattr(torch, state_dtype) if state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        mu=_tree.map(zeros_like, params), nu=_tree.map(zeros_like, params))


def adamw_update(params, grads, state: OptState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0):
    """Returns (new_params, new_state).  ``lr`` may be a scalar or a
    step-indexed callable."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    g_leaves, skeleton = _tree.flatten(grads)

    if grad_clip is not None:
        total = 0
        for g in g_leaves:
            total = total + g.float().square().sum()
        gnorm = torch.sqrt(total + 1e-16)
        scale = torch.clamp(grad_clip / gnorm, max=1.0)
        g_leaves = [g * scale.to(g.dtype) for g in g_leaves]

    stepf = step.to(torch.float32)
    c1 = 1.0 - b1 ** stepf
    c2 = 1.0 - b2 ** stepf

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(_tree.leaves(params), g_leaves,
                          _tree.leaves(state.mu), _tree.leaves(state.nu)):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf.square()
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p_new = p.float() - lr_t * delta
        new_p.append(p_new.to(p.dtype))
        new_m.append(m_new.to(m.dtype))
        new_v.append(v_new.to(v.dtype))
    return (_tree.unflatten(skeleton, new_p),
            OptState(step=step, mu=_tree.unflatten(skeleton, new_m),
                     nu=_tree.unflatten(skeleton, new_v)))
