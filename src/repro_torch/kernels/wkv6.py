"""RWKV-6 WKV recurrence — the port of ``repro.kernels.wkv6.wkv6_pallas``
with the model's interface (``repro.models.rwkv.wkv6_chunked``): a
per-head ``u``, an optional initial state, and the final state returned —
and its backward, which the reference takes by ``jax``'s autodiff.

The CUDA kernels are ``csrc/wkv6.cu`` (design notes there): a chunked
tensor-core form for T > 1 and a state-streaming decode for T <= 1, on the
plan of :func:`repro_torch.kernels.plan.wkv6_plan`; and
``csrc/wkv6_bwd.cu``, the backward, on the plan of
:func:`repro_torch.kernels.plan.wkv6_bwd_plan`.  The two are operators
of their own, ``torch.ops.repro_torch.wkv6`` (:func:`wkv6_op`) and
``wkv6_bwd``, the second the first's gradient: on CUDA tensors they
launch the kernels or raise, on CPU tensors they run their plain versions
(:func:`repro_torch.kernels.ref.wkv6_chunked_ref`,
:func:`repro_torch.kernels.ref.wkv6_bwd_ref`), on fake tensors they give
shapes alone, and ``torch.utils.flop_counter`` counts the operations their
routes run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._launch import I, P, check_cuda, fake_only, raise_on_error, stream_ptr
from .plan import (WKV_BWD_V_MAX, WKV_K_MAX, wkv6_bwd_ops, wkv6_bwd_plan,
                   wkv6_ops, wkv6_plan)
from .ref import wkv6_bwd_ref, wkv6_chunked_ref

__all__ = ["wkv6_dev", "wkv6_cuda", "wkv6_bwd_cuda", "wkv6_op",
           "wkv6_bwd_op", "WKV6_LAUNCHES", "WKV6_BWD_LAUNCHES"]

#: kernel launches since the last reset (see :mod:`repro_torch.kernels`):
#: the forward and the backward
WKV6_LAUNCHES = 0
WKV6_BWD_LAUNCHES = 0

#: input dtype → the C entry point's ``types`` code
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("wkv6")
    if not getattr(lib, "_typed", False):
        lib.repro_wkv6.argtypes = [I] + [P] * 8 + [I] * 14 + [P]
        lib.repro_wkv6.restype = I
        lib._typed = True
    return lib


def _bwd_lib():
    lib = _build.library("wkv6_bwd")
    if not getattr(lib, "_typed", False):
        lib.repro_wkv6_bwd.argtypes = [I] + [P] * 15 + [I] * 15 + [P]
        lib.repro_wkv6_bwd.restype = I
        lib._typed = True
    return lib


def _check(name: str, r, k, v, w, u, state) -> None:
    """The forward's and the backward's shared refusals: types and shapes
    (the devices are checked after, by the caller)."""
    dt = r.dtype
    if dt not in _TYPES:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {dt}")
    if any(t.dtype != dt for t in (k, v, w)) or u.dtype != torch.float32 \
            or (state is not None and state.dtype != torch.float32):
        raise ValueError(f"{name}: r, k, v, w must share one type and u, "
                         f"state be float32, got {r.dtype} {k.dtype} "
                         f"{v.dtype} {w.dtype} u {u.dtype}")
    if r.dim() != 3 or v.dim() != 3 or u.dim() != 2:
        raise ValueError(f"{name}: expected r, k, v, w of rank 3 and u of "
                         f"rank 2, got {tuple(r.shape)} {tuple(v.shape)} "
                         f"{tuple(u.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:2] != (BH, T) \
            or u.shape[1] != K or H == 0 or BH % H:
        raise ValueError(f"{name}: shapes differ, r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} w "
                         f"{tuple(w.shape)} u {tuple(u.shape)}")
    if K % 8 or K > WKV_K_MAX or BH > 65535:
        raise ValueError(f"{name}: the head size must be a multiple of 8 up "
                         f"to {WKV_K_MAX} and B*H at most 65535, got K={K}, "
                         f"BH={BH}")
    if state is not None and tuple(state.shape) != (BH, K, V):
        raise ValueError(f"{name}: state must be {(BH, K, V)}, got "
                         f"{tuple(state.shape)}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 on the card.  r, k, w (BH, T, K) and v (BH, T, V) float32 or
    bfloat16, all one type; u (H, K) float32 (row bh uses head bh % H);
    ``state`` (BH, K, V) float32 or None for zeros.  Returns (out (BH, T,
    V) in the input type, final state (BH, K, V) float32), one launch on
    the :func:`wkv6_plan` of the shape."""
    global WKV6_LAUNCHES
    dev, dt = r.device, r.dtype
    # types and shapes first, then devices: every refusal raises
    _check("wkv6", r, k, v, w, u, state)
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t is not None:
            check_cuda(f"wkv6 {name}", t, t.dtype, t.dim(), dev)
    out = torch.empty((BH, T, V), dtype=dt, device=dev)
    s_out = torch.empty((BH, K, V), dtype=torch.float32, device=dev)
    if BH == 0 or V == 0:
        return out, s_out
    # 16-byte state rows for the decode when the layout allows them
    vec = 4 if V % 4 == 0 and (state is None or state.data_ptr() % 16 == 0) \
        else 1
    p = wkv6_plan(T, K, V, BH, vec)
    err = _lib().repro_wkv6(_TYPES[dt], r.data_ptr(), k.data_ptr(),
                            v.data_ptr(), w.data_ptr(), u.data_ptr(),
                            None if state is None else state.data_ptr(),
                            out.data_ptr(), s_out.data_ptr(), BH, H, T, K, V,
                            p.route_code, p.chunk, p.sub, p.kk, p.vb, p.vec,
                            p.grid[0], p.smem_bytes, p.blocks_per_sm,
                            stream_ptr(dev))
    raise_on_error("wkv6", err)
    WKV6_LAUNCHES += 1
    return out, s_out


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: Optional[torch.Tensor], do: torch.Tensor,
                  dS_T: Optional[torch.Tensor] = None):
    """The WKV6 backward on the card.  r, k, w (BH, T, K), v and the
    output's cotangent ``do`` (BH, T, V) float32 or bfloat16, all one
    type; u (H, K) float32; ``state`` S_0 and the final state's cotangent
    ``dS_T`` (BH, K, V) float32 or None for zeros.  Returns (dr, dk, dv,
    dw) in the input type, du (H, K) float32 (the kernel's sums by row
    and chunk added over the chunks and the batch in a fixed order) and
    dS_0 (BH, K, V) float32, from the :func:`wkv6_bwd_plan` of the shape
    (its ``launches``: the boundary states, then every chunk at once)."""
    global WKV6_BWD_LAUNCHES
    dev, dt = r.device, r.dtype
    _check("wkv6_bwd", r, k, v, w, u, state)
    BH, T, K = r.shape
    V = v.shape[-1]
    H = u.shape[0]
    if do.dtype != dt or do.shape != v.shape:
        raise ValueError(f"wkv6_bwd: do must be {dt} {tuple(v.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    if dS_T is not None and (dS_T.dtype != torch.float32
                             or tuple(dS_T.shape) != (BH, K, V)):
        raise ValueError(f"wkv6_bwd: dS_T must be float32 {(BH, K, V)}, "
                         f"got {dS_T.dtype} {tuple(dS_T.shape)}")
    if V > WKV_BWD_V_MAX:
        raise ValueError(f"wkv6_bwd: at most {WKV_BWD_V_MAX} state columns, "
                         f"got V={V}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state), ("do", do), ("dS_T", dS_T)):
        if t is not None:
            check_cuda(f"wkv6_bwd {name}", t, t.dtype, t.dim(), dev)
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    if BH == 0 or V == 0:
        return (dr, dk, dv, dw, torch.zeros_like(u),
                torch.zeros((BH, K, V), dtype=torch.float32, device=dev)
                if dS_T is None else dS_T.clone())
    p = wkv6_bwd_plan(T, K, V, BH)
    du_part = torch.empty((BH, p.n_chunks, K), dtype=torch.float32,
                          device=dev)
    ds0 = torch.empty((BH, K, V), dtype=torch.float32, device=dev)
    scratch = torch.empty(p.scratch_bytes // 4, dtype=torch.float32,
                          device=dev)
    err = _bwd_lib().repro_wkv6_bwd(
        _TYPES[dt], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        do.data_ptr(), None if dS_T is None else dS_T.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_part.data_ptr(), ds0.data_ptr(), scratch.data_ptr(), BH, H, T, K,
        V, p.kk, p.vv, p.chunk, p.sub, p.n_chunks, p.states_threads,
        p.states_smem, p.threads, p.smem_bytes, p.blocks_per_sm,
        stream_ptr(dev))
    raise_on_error("wkv6_bwd", err)
    WKV6_BWD_LAUNCHES += 1
    # du: the chunks of a row, then the batch, each in a fixed order
    du = du_part.sum(1).reshape(BH // H, H, K).sum(0)
    return dr, dk, dv, dw, du, ds0


def _heads(t: Optional[torch.Tensor], H: int):
    """(BH, ·, ·) rows as the plain versions' (B, H, ·, ·)."""
    return None if t is None else t.reshape(t.shape[0] // H, H,
                                            *t.shape[1:])


# The WKV and its backward as operators of their own: one entry
# (``torch.ops.repro_torch.wkv6`` / ``wkv6_bwd``), an implementation per
# device -- the kernels on CUDA tensors (launched or raising), the plain
# versions on CPU tensors -- and a fake one that gives shapes and dtypes
# alone, so FakeTensorMode traces the model through the WKV without a
# launch.  Their FLOP formulas credit the operations their routes run
# (plan.wkv6_ops, plan.wkv6_bwd_ops).

@torch.library.custom_op(
    "repro_torch::wkv6", mutates_args=(), device_types="cpu",
    schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? "
           "state, int chunk) -> (Tensor, Tensor)")
def wkv6_op(r, k, v, w, u, state, chunk):
    """WKV6 in :func:`wkv6_cuda`'s layout: (r, k, v, w, u, state, chunk)
    → (out, final state).  CPU tensors: the plain chunked version,
    ``chunk`` steps a chunk."""
    H = u.shape[0]
    out, s = wkv6_chunked_ref(_heads(r, H), _heads(k, H), _heads(v, H),
                              _heads(w, H), u, _heads(state, H),
                              chunk=chunk)
    # contiguous, as the kernel's and the fake implementation's outputs
    return (out.reshape(v.shape).contiguous(),
            s.reshape(r.shape[0], *s.shape[2:]).contiguous())


@wkv6_op.register_kernel("cuda")
def _(r, k, v, w, u, state, chunk):
    return wkv6_cuda(r, k, v, w, u, state)


@wkv6_op.register_fake
def _(r, k, v, w, u, state, chunk):
    fake_only("wkv6", r)
    _check("wkv6", r, k, v, w, u, state)
    BH, T, K = r.shape
    V = v.shape[-1]
    return (r.new_empty((BH, T, V)),
            r.new_empty((BH, K, V), dtype=torch.float32))


@torch.library.custom_op(
    "repro_torch::wkv6_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? "
           "state, Tensor do, Tensor? dS_T) -> (Tensor, Tensor, Tensor, "
           "Tensor, Tensor, Tensor)")
def wkv6_bwd_op(r, k, v, w, u, state, do, dS_T):
    """The WKV6 backward in :func:`wkv6_bwd_cuda`'s layout → (dr, dk, dv,
    dw, du, dS_0).  CPU tensors: the plain version."""
    H = u.shape[0]
    dr, dk, dv, dw, du, ds0 = wkv6_bwd_ref(
        _heads(r, H), _heads(k, H), _heads(v, H), _heads(w, H), u,
        _heads(state, H), _heads(do, H), _heads(dS_T, H))
    return tuple(t.contiguous() for t in (
        dr.reshape(r.shape), dk.reshape(r.shape), dv.reshape(v.shape),
        dw.reshape(r.shape), du, ds0.reshape(r.shape[0], *ds0.shape[2:])))


@wkv6_bwd_op.register_kernel("cuda")
def _(r, k, v, w, u, state, do, dS_T):
    return wkv6_bwd_cuda(r, k, v, w, u, state, do, dS_T)


@wkv6_bwd_op.register_fake
def _(r, k, v, w, u, state, do, dS_T):
    fake_only("wkv6_bwd", r)
    _check("wkv6_bwd", r, k, v, w, u, state)
    BH, _, K = r.shape
    V = v.shape[-1]
    return (torch.empty_like(r), torch.empty_like(r), torch.empty_like(v),
            torch.empty_like(r), torch.empty_like(u),
            r.new_empty((BH, K, V), dtype=torch.float32))


def _wkv6_setup(ctx, inputs, output):
    r, k, v, w, u, state, _ = inputs
    # an unused output sends no cotangent, so none is made of zeros
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(r, k, v, w, u, state)


def _wkv6_backward(ctx, d_out, d_state):
    r, k, v, w, u, state = ctx.saved_tensors
    if d_out is None:
        d_out = torch.zeros_like(v)
    else:
        d_out = d_out.to(v.dtype).contiguous()
    if d_state is not None:
        d_state = d_state.float().contiguous()
    dr, dk, dv, dw, du, ds0 = wkv6_bwd_op(r, k, v, w, u, state, d_out,
                                          d_state)
    need = ctx.needs_input_grad
    return (dr if need[0] else None, dk if need[1] else None,
            dv if need[2] else None, dw if need[3] else None,
            du if need[4] else None,
            ds0 if state is not None and need[5] else None, None)


wkv6_op.register_autograd(_wkv6_backward, setup_context=_wkv6_setup)


def _wkv6_flops(r, k, v, w, u, state, chunk, out_val=None, **_):
    BH, T, K = r.shape
    return int(wkv6_ops(T, K, v.shape[-1], BH, r.element_size())[0])


def _wkv6_bwd_flops(r, k, v, w, u, state, do, dS_T, out_val=None, **_):
    BH, T, K = r.shape
    V = v.shape[-1]
    ops = wkv6_bwd_ops(T, K, V, BH, r.element_size(),
                       wkv6_bwd_plan(T, K, V, BH).chunk)
    return int(sum(ops.values()))


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.wkv6,
                          get_raw=True)(_wkv6_flops)
    register_flop_formula(torch.ops.repro_torch.wkv6_bwd,
                          get_raw=True)(_wkv6_bwd_flops)


_register_flops()


def wkv6_dev(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: Optional[torch.Tensor] = None, *, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over (BH, T, ·) rows with u (H, K), differentiable through
    the ``wkv6`` operator (:func:`wkv6_op`): the kernels for CUDA tensors,
    the plain versions (the forward in chunks of ``chunk`` steps) for CPU
    tensors, shapes alone for fake ones.  Returns (out, final state) as
    :func:`wkv6_cuda` does."""
    return wkv6_op(r, k, v, w, u, state, chunk)
