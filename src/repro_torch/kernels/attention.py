"""Blockwise softmax attention and its gradient -- the port of the
reference's jnp ``repro.models.attention.flash_attention`` (no Pallas
kernel: its blockwise online softmax bounds XLA's compiled memory, and
``jax``'s autodiff of the scan gives its gradient).

The CUDA kernels are two forwards -- ``csrc/attention_mma.cu`` (bf16 at
head sizes that are multiples of 16 up to 256, the larger above 32: Q Kᵀ
and P V on the tensor cores with ``wgmma``, K / V brought by TMA, on the
plan of :func:`repro_torch.kernels.plan.attention_mma_plan`) and
``csrc/attention.cu`` (float32, and the smoke configs' heads of 16 and 24:
SIMT, on the FP32 pipe) -- each one block per query tile of a kv head's
group, the keys its masks leave, an online softmax in float32, writing
the rows' log-sum-exp; and ``csrc/attention_bwd.cu`` (the backward: a dQ
kernel, which also forms D_i = Σ dO ⊙ O, then a dK / dV kernel; no
atomics) on the plan of :func:`repro_torch.kernels.plan.attention_plan`.
Which forward a call takes follows from its type and head sizes alone
(:func:`attention_route`), never from a failure.  They are two operators,
``torch.ops.repro_torch.attention`` (:func:`attention_op`) and
``attention_bwd``, the second the first's gradient: on CUDA tensors they
launch the kernels or raise, on CPU tensors they run their plain versions
(:func:`repro_torch.kernels.ref.attention_ref`,
:func:`repro_torch.kernels.ref.attention_bwd_ref`, over the reference's
blocks ``block_q`` x ``block_k``), on fake tensors they give shapes alone,
and ``torch.utils.flop_counter`` counts the pairs the reference's block
range visits (:func:`repro_torch.kernels.plan.attention_flops`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._launch import (F32, I, P, check_cuda, fake_only, raise_on_error,
                      stream_ptr)
from .plan import attention_flops, attention_mma_plan, attention_plan
from .ref import attention_bwd_ref, attention_ref

__all__ = ["attention_cuda", "attention_bwd_cuda", "attention_op",
           "attention_bwd_op", "attention_route", "LAUNCHES", "MMA_LAUNCHES",
           "SIMT_LAUNCHES", "BWD_LAUNCHES"]

#: launches since the last reset (see :mod:`repro_torch.kernels`): the
#: forward's calls on the card, either kernel (``LAUNCHES``), and each
#: forward kernel's own (``MMA_LAUNCHES``: csrc/attention_mma.cu,
#: ``SIMT_LAUNCHES``: csrc/attention.cu); the backward (one count a call of
#: its two kernels)
LAUNCHES = 0
MMA_LAUNCHES = 0
SIMT_LAUNCHES = 0
BWD_LAUNCHES = 0

#: input dtype → the C entry point's ``types`` code
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("attention")
    if not getattr(lib, "_typed", False):
        lib.repro_attention.argtypes = ([I] + [P] * 6 + [I] * 11 + [F32]
                                        + [I] * 7 + [P])
        lib.repro_attention.restype = I
        lib._typed = True
    return lib


def _mma_lib():
    lib = _build.library("attention_mma")
    if not getattr(lib, "_typed", False):
        lib.repro_attention_mma.argtypes = ([P] * 6 + [I] * 11 + [F32]
                                            + [I] * 10 + [P])
        lib.repro_attention_mma.restype = I
        lib._typed = True
    return lib


def _bwd_lib():
    lib = _build.library("attention_bwd")
    if not getattr(lib, "_typed", False):
        lib.repro_attention_bwd.argtypes = ([I] + [P] * 11 + [I] * 11
                                            + [F32] + [I] * 10 + [P])
        lib.repro_attention_bwd.restype = I
        lib._typed = True
    return lib


def _check(name: str, q, k, v, kv_valid) -> Tuple[int, ...]:
    """Types and shapes (the devices are checked after, by the caller);
    returns (B, Tq, Tk, Hq, Hkv, D, Dv)."""
    dt = q.dtype
    if dt not in _TYPES or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"{name}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected q, k, v of rank 4, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Tq, Hq, D = q.shape
    _, Tk, Hkv, Dv = v.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D \
            or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: shapes differ, q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (Hq a "
                         f"multiple of Hkv)")
    if kv_valid is not None and (kv_valid.dtype != torch.int32
                                 or tuple(kv_valid.shape) != (B,)):
        raise ValueError(f"{name}: kv_valid must be int32 ({B},), got "
                         f"{kv_valid.dtype} {tuple(kv_valid.shape)}")
    return B, Tq, Tk, Hq, Hkv, D, Dv


def attention_route(dtype: torch.dtype, D: int, Dv: int) -> str:
    """The forward kernel a call of this type and head sizes takes: "mma"
    (``csrc/attention_mma.cu``) where :func:`attention_mma_plan` takes it --
    bf16, D and Dv multiples of 16 up to 256, the larger above 32 -- else
    "simt" (``csrc/attention.cu``)."""
    if dtype != torch.bfloat16:
        return "simt"
    try:
        attention_mma_plan(D, Dv, 1)
    except ValueError:
        return "simt"
    return "mma"


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor], causal: bool,
                   window: Optional[int], q_offset: int, scale: float,
                   route: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention forward on the card.  q (B, Tq, Hq, D), k (B, Tk, Hkv,
    D), v (B, Tk, Hkv, Dv) float32 or bfloat16, one type, contiguous (the
    tensor-core kernel's TMA wants 16-byte aligned bases, as allocations
    are); ``kv_valid`` (B,) int32 or None.  Returns (out (B, Tq, Hq, Dv) in the
    input type, lse (B, Hq, Tq) float32), one launch of the kernel of
    :func:`attention_route` (``route`` "mma" or "simt" names it instead:
    ``chip_smoke.py`` times the SIMT kernel on the tensor-core route's
    inputs)."""
    global LAUNCHES, MMA_LAUNCHES, SIMT_LAUNCHES
    dev = q.device
    B, Tq, Tk, Hq, Hkv, D, Dv = _check("attention", q, k, v, kv_valid)
    route = route or attention_route(q.dtype, D, Dv)
    if route not in ("mma", "simt"):
        raise ValueError(f"attention: route must be 'mma' or 'simt', got "
                         f"{route!r}")
    p = (attention_mma_plan if route == "mma" else attention_plan)(
        D, Dv, Hq // Hkv, q.element_size())
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_valid", kv_valid)):
        if t is not None:
            check_cuda(f"attention {name}", t, t.dtype, t.dim(), dev)
    out = torch.empty((B, Tq, Hq, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev)
    if B == 0 or Tq == 0:
        return out, lse
    args = (None if kv_valid is None else kv_valid.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Tq, Tk, Hq, Hkv, D, Dv,
            int(causal), int(window is not None),
            0 if window is None else int(window), int(q_offset),
            float(scale))
    if route == "mma":
        err = _mma_lib().repro_attention_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *args, p.dc, p.vc,
            p.rows, p.gt, p.bq, p.bk, p.stages, p.threads, p.smem_bytes,
            p.blocks_per_sm, stream_ptr(dev))
        raise_on_error("attention_mma", err)
        MMA_LAUNCHES += 1
    else:
        err = _lib().repro_attention(
            _TYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *args, p.width, p.gt, p.bq, p.bk, p.threads, p.smem_bytes,
            p.blocks_per_sm, stream_ptr(dev))
        raise_on_error("attention", err)
        SIMT_LAUNCHES += 1
    LAUNCHES += 1
    return out, lse


def attention_bwd_cuda(q, k, v, out, lse, do, kv_valid, causal: bool,
                       window: Optional[int], q_offset: int, scale: float):
    """The attention backward on the card: q, k, v, ``kv_valid`` as
    :func:`attention_cuda`'s, its output ``out`` and row log-sum-exp
    ``lse``, the output's cotangent ``do`` (out's type and shape).
    Returns (dq, dk, dv) in the input type: the dQ kernel (which writes
    D_i) then the dK / dV kernel, counted as one launch."""
    global BWD_LAUNCHES
    dev = q.device
    B, Tq, Tk, Hq, Hkv, D, Dv = _check("attention_bwd", q, k, v, kv_valid)
    p = attention_plan(D, Dv, Hq // Hkv, q.element_size())
    for name, t, shape, dt in (("out", out, (B, Tq, Hq, Dv), q.dtype),
                               ("do", do, (B, Tq, Hq, Dv), q.dtype),
                               ("lse", lse, (B, Hq, Tq), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"attention_bwd: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("lse", lse), ("do", do), ("kv_valid", kv_valid)):
        if t is not None:
            check_cuda(f"attention_bwd {name}", t, t.dtype, t.dim(), dev)
    if B == 0 or Tq == 0 or Tk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di = torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev)
    err = _bwd_lib().repro_attention_bwd(
        _TYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), do.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), di.data_ptr(), B, Tq, Tk, Hq, Hkv, D,
        Dv, int(causal), int(window is not None),
        0 if window is None else int(window), int(q_offset), float(scale),
        p.width, p.gt, p.bq, p.bk, p.bn, p.threads, p.dq_smem, p.dkdv_smem,
        p.dq_blocks_per_sm, p.dkdv_blocks_per_sm, stream_ptr(dev))
    raise_on_error("attention_bwd", err)
    BWD_LAUNCHES += 1
    return dq, dk, dv


# The attention and its backward as operators of their own: one entry
# (``torch.ops.repro_torch.attention`` / ``attention_bwd``), an
# implementation per device -- the kernels on CUDA tensors (launched or
# raising), the plain versions on CPU tensors -- and a fake one that gives
# shapes and dtypes alone, so FakeTensorMode traces a model through the
# attention without a (T, T) tensor.  ``block_q`` / ``block_k`` are the
# reference's blocks: the plain versions and the FLOP formulas read them,
# the kernels tile by their plan.

_SCHEMA_ARGS = ("Tensor? kv_valid, bool causal, int? window, int q_offset, "
                "float scale, int block_q, int block_k")


@torch.library.custom_op(
    "repro_torch::attention", mutates_args=(), device_types="cpu",
    schema=f"(Tensor q, Tensor k, Tensor v, {_SCHEMA_ARGS}) -> "
           f"(Tensor, Tensor)")
def attention_op(q, k, v, kv_valid, causal, window, q_offset, scale,
                 block_q, block_k):
    """Attention in :func:`attention_cuda`'s layout → (out, lse).  CPU
    tensors: the plain blockwise version."""
    out, lse = attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_valid=kv_valid,
                             block_q=block_q, block_k=block_k, scale=scale)
    return out.contiguous(), lse.contiguous()


@attention_op.register_kernel("cuda")
def _(q, k, v, kv_valid, causal, window, q_offset, scale, block_q, block_k):
    return attention_cuda(q, k, v, kv_valid, causal, window, q_offset,
                          scale)


@attention_op.register_fake
def _(q, k, v, kv_valid, causal, window, q_offset, scale, block_q, block_k):
    fake_only("attention", q)
    B, Tq, _, Hq, _, _, Dv = _check("attention", q, k, v, kv_valid)
    return (q.new_empty((B, Tq, Hq, Dv)),
            q.new_empty((B, Hq, Tq), dtype=torch.float32))


@torch.library.custom_op(
    "repro_torch::attention_bwd", mutates_args=(), device_types="cpu",
    schema=f"(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor "
           f"do, {_SCHEMA_ARGS}) -> (Tensor, Tensor, Tensor)")
def attention_bwd_op(q, k, v, out, lse, do, kv_valid, causal, window,
                     q_offset, scale, block_q, block_k):
    """The attention backward in :func:`attention_bwd_cuda`'s layout →
    (dq, dk, dv).  CPU tensors: the plain blockwise version."""
    dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window, q_offset=q_offset,
                                   kv_valid=kv_valid, block_q=block_q,
                                   block_k=block_k, scale=scale)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@attention_bwd_op.register_kernel("cuda")
def _(q, k, v, out, lse, do, kv_valid, causal, window, q_offset, scale,
      block_q, block_k):
    return attention_bwd_cuda(q, k, v, out, lse, do, kv_valid, causal,
                              window, q_offset, scale)


@attention_bwd_op.register_fake
def _(q, k, v, out, lse, do, kv_valid, causal, window, q_offset, scale,
      block_q, block_k):
    fake_only("attention_bwd", q)
    _check("attention_bwd", q, k, v, kv_valid)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _attention_setup(ctx, inputs, output):
    q, k, v, kv_valid, *rest = inputs
    out, lse = output
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(q, k, v, out, lse, kv_valid)
    ctx.rest = rest


def _attention_backward(ctx, d_out, d_lse):
    q, k, v, out, lse, kv_valid = ctx.saved_tensors
    if d_out is None:
        return None, None, None, None, None, None, None, None, None, None
    dq, dk, dv = attention_bwd_op(q, k, v, out, lse,
                                  d_out.to(q.dtype).contiguous(), kv_valid,
                                  *ctx.rest)
    need = ctx.needs_input_grad
    return (dq if need[0] else None, dk if need[1] else None,
            dv if need[2] else None, None, None, None, None, None, None,
            None)


attention_op.register_autograd(_attention_backward,
                               setup_context=_attention_setup)


def _flops(q, v, causal, window, q_offset, block_q, block_k,
           backward: bool) -> int:
    B, Tq, Hq, D = q.shape
    return attention_flops(B, Tq, v.shape[1], Hq, D, v.shape[3], causal,
                           window, q_offset, block_q, block_k, backward)


def _attention_flops(q, k, v, kv_valid, causal, window, q_offset, scale,
                     block_q, block_k, out_val=None, **_):
    return _flops(q, v, causal, window, q_offset, block_q, block_k, False)


def _attention_bwd_flops(q, k, v, out, lse, do, kv_valid, causal, window,
                         q_offset, scale, block_q, block_k, out_val=None,
                         **_):
    return _flops(q, v, causal, window, q_offset, block_q, block_k, True)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.attention,
                          get_raw=True)(_attention_flops)
    register_flop_formula(torch.ops.repro_torch.attention_bwd,
                          get_raw=True)(_attention_bwd_flops)


_register_flops()
