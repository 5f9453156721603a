"""The WKV backward of the port against the reference's gradient, on the
CPU.

``ref.wkv6_bwd_ref`` (the plain version the ``wkv6`` operator runs on CPU
tensors) and ``ref.wkv6_bwd_chunked_ref`` (the two-level form
``csrc/wkv6_bwd.cu`` runs: boundary states chunk by chunk, then every
chunk from its two boundary states, dw in the direct form) against
``jax.grad`` of ``repro.models.rwkv.wkv6_chunked`` and against float64
autograd of the sequential recurrence (with an initial state and a final
state cotangent, at moderate and at strong decays, where only the
sequential form is finite), and against each other at a ragged T;
``kernels.wkv6.wkv6_op`` on CPU tensors against autograd of
``ref.wkv6_chunked_ref``; the backward's launch plan
(``plan.wkv6_bwd_plan``) and its wrapper's refusals.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` phase c holds them to
the plain version there).  Inputs come from seeded numpy generators.

Tolerances, each relative to 1 + the largest entry of the reference:
1e-5 against ``jax.grad`` of the chunked form (float32 sums in another
order; the chunked form's exp(±cumsum log w) factors round apart;
measured at most 9.4e-7) and 1e-6 against the float64 oracle (one float32
recurrence; measured at most 2.2e-7).
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import wkv6 as twkv6  # noqa: E402
from repro_torch.kernels.plan import wkv6_bwd_plan  # noqa: E402

NAMES = ("dr", "dk", "dv", "dw", "du", "dS_0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, T, K, V, seed, lo=0.5, hi=1.0, zero_every=0):
    """r, k, v, w, u, S_0, do, dS_T as float32 numpy: N(0, 1) but the
    decays, uniform in [lo, hi) with every ``zero_every``-th step exactly
    0 when set, and u ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)
    r, k = n(B, H, T, K), n(B, H, T, K)
    v = n(B, H, T, V)
    w = rng.uniform(lo, hi, size=(B, H, T, K)).astype(np.float32)
    if zero_every:
        w[:, :, ::zero_every] = 0.0
    u = 0.1 * n(H, K)
    return r, k, v, w, u, n(B, H, K, V), n(B, H, T, V), n(B, H, K, V)


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x))
            for x in xs]


def _close(ours, ref, tol, name=""):
    a = ours.detach().double().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours, np.float64)
    b = ref.detach().double().numpy() if isinstance(ref, torch.Tensor) \
        else np.asarray(ref, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    err = np.abs(a - b).max() if b.size else 0.0
    assert err <= tol * (1.0 + (np.abs(b).max() if b.size else 0.0)), \
        (name, err)


@functools.lru_cache(maxsize=None)
def _jax_grads(T):
    """``jax.grad`` of sum(wkv6_chunked(r, k, v, w, u)[0] * do) for the
    seeded inputs of T steps, B 2 H 2 K = V = 16 (shared by the tests of
    both plain versions)."""
    r, k, v, w, u, _, do, _ = _inputs(2, 2, T, 16, 16, seed=T)

    def loss(r, k, v, w, u):
        out, _ = jrwkv.wkv6_chunked(r, k, v, w, u)
        return jnp.sum(out * do)
    return tuple(np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (r, k, v, w, u))))


@pytest.mark.parametrize("T", [1, 16, 37, 64, 130])
def test_bwd_ref_matches_jax_grad_of_reference(T):
    """dr, dk, dv, dw, du of ``wkv6_bwd_ref`` (no S_0, no final-state
    cotangent: the reference's training forward) against ``jax.grad`` of
    sum(wkv6_chunked(...)[0] * do), float32, B 2 H 2 K = V = 16, decays
    in [0.5, 1), T across one, ragged and several chunks of 64."""
    r, k, v, w, u, _, do, _ = _inputs(2, 2, T, 16, 16, seed=T)
    got = tref.wkv6_bwd_ref(*_t(r, k, v, w, u), None, *_t(do), None)
    for name, a, b in zip(NAMES, got, _jax_grads(T)):
        assert a.dtype == torch.float32
        _close(a, b, 1e-5, name)


@pytest.mark.parametrize("T", [1, 16, 37, 64, 130])
def test_bwd_chunked_ref_matches_jax_grad_of_reference(T):
    """The two-level form (chunks of 16: one, ragged and several) against
    the same ``jax.grad`` at the same tolerance."""
    r, k, v, w, u, _, do, _ = _inputs(2, 2, T, 16, 16, seed=T)
    got = tref.wkv6_bwd_chunked_ref(*_t(r, k, v, w, u), None, *_t(do),
                                    None)
    for name, a, b in zip(NAMES, got, _jax_grads(T)):
        assert a.dtype == torch.float32
        _close(a, b, 1e-5, name)


def _seq64_grads(r, k, v, w, u, s0, do, dS):
    """float64 autograd of the sequential recurrence (the decays clamped
    at 1e-12) for L = sum(out * do) + sum(S_T * dS_T)."""
    xs = [torch.from_numpy(x.astype(np.float64)).requires_grad_()
          for x in (r, k, v, w, u, s0)]
    out, s = tref.wkv6_seq_ref(*xs)
    loss = (out * torch.from_numpy(do.astype(np.float64))).sum() \
        + (s * torch.from_numpy(dS.astype(np.float64))).sum()
    return torch.autograd.grad(loss, xs)


#: the decay sweeps (lo, hi, every n-th step exactly 0)
DECAY_SWEEPS = [
    (0.5, 1.0, 0),          # moderate
    (1e-3, 0.3, 0),         # strong: the chunked form leaves float32
    (1e-3, 0.3, 4),         # strong, every 4th step exactly 0 (the clamp)
    (0.0, 1e-11, 3)]        # below and about the 1e-12 clamp


@functools.lru_cache(maxsize=None)
def _sweep(lo, hi, zero_every):
    """The seeded inputs of a decay sweep (B 1 H 2 T 41 K 16 V 24, with
    S_0 and dS_T) and float64 autograd of the sequential recurrence on
    them."""
    xs = _inputs(1, 2, 41, 16, 24, seed=3, lo=lo, hi=hi,
                 zero_every=zero_every)
    return xs, _seq64_grads(*xs)


@pytest.mark.parametrize("lo,hi,zero_every", DECAY_SWEEPS)
def test_bwd_ref_with_state_matches_float64_sequential(lo, hi, zero_every):
    """Every output of ``wkv6_bwd_ref`` with S_0 and a dS_T cotangent
    against float64 autograd of the sequential recurrence, B 1 H 2 T 41 K
    16 V 24.  A decay below the 1e-12 clamp gets a zero dw, as the
    reference's ``jnp.maximum`` gives it."""
    (r, k, v, w, u, s0, do, dS), want = _sweep(lo, hi, zero_every)
    got = tref.wkv6_bwd_ref(*_t(r, k, v, w, u, s0, do, dS))
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-6, name)
    if zero_every:
        assert not got[3][:, :, ::zero_every].any()
    # the chunked form's growth factors leave float32 at strong decays
    if hi <= 0.3:
        out, _ = tref.wkv6_chunked_ref(*_t(r, k, v, w, u))
        assert not torch.isfinite(out).all()


@pytest.mark.parametrize("lo,hi,zero_every", DECAY_SWEEPS)
def test_bwd_chunked_ref_with_state_matches_float64_sequential(lo, hi,
                                                               zero_every):
    """The two-level form against the same float64 autograd at the same
    tolerance, T 41 ragged against the chunk of 16: its chunk products of
    decays (each <= 1, no division) stay finite and accurate at strong
    decays and at the clamp, and dw is 0 below it."""
    (r, k, v, w, u, s0, do, dS), want = _sweep(lo, hi, zero_every)
    got = tref.wkv6_bwd_chunked_ref(*_t(r, k, v, w, u, s0, do, dS))
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-6, name)
    if zero_every:
        assert not got[3][:, :, ::zero_every].any()


@pytest.mark.parametrize("chunk", [8, 16])
def test_bwd_chunked_ref_matches_plain_at_ragged_T(chunk):
    """The two-level form against ``wkv6_bwd_ref`` at T 37 (ragged against
    both chunks), B 2 H 2 K 16 V 24, with S_0 and dS_T: every output
    within 1e-6 (both float32, sums in another order); bf16 inputs give
    bf16 dr, dk, dv, dw within one bf16 step of the plain version."""
    r, k, v, w, u, s0, do, dS = _inputs(2, 2, 37, 16, 24, seed=7)
    want = tref.wkv6_bwd_ref(*_t(r, k, v, w, u, s0, do, dS))
    got = tref.wkv6_bwd_chunked_ref(*_t(r, k, v, w, u, s0, do, dS),
                                    chunk=chunk)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-6, name)
    bf = [t.to(torch.bfloat16) for t in _t(r, k, v, w, do)]
    want = tref.wkv6_bwd_ref(*bf[:4], *_t(u, s0), bf[4], *_t(dS))
    got = tref.wkv6_bwd_chunked_ref(*bf[:4], *_t(u, s0), bf[4], *_t(dS),
                                    chunk=chunk)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype
        _close(a.float(), b.float(), 2.0 ** -7, name)


def test_bwd_ref_types():
    """bf16 inputs give dr, dk, dv, dw in bf16 (rounded from the float32
    result) and du, dS_0 in float32; no step gives empty gradients and
    dS_0 = dS_T."""
    r, k, v, w, u, s0, do, dS = _inputs(1, 2, 9, 8, 8, seed=4)
    bf = [t.to(torch.bfloat16) for t in _t(r, k, v, w)]
    got = tref.wkv6_bwd_ref(*bf, *_t(u, s0), _t(do)[0].to(torch.bfloat16),
                            *_t(dS))
    assert [t.dtype for t in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    f32 = tref.wkv6_bwd_ref(*(t.float() for t in bf), *_t(u, s0),
                            _t(do)[0].to(torch.bfloat16).float(), *_t(dS))
    for a, b in zip(got[:4], f32[:4]):
        assert torch.equal(a, b.to(torch.bfloat16))
    empty = tref.wkv6_bwd_ref(*(t[:, :, :0] for t in _t(r, k, v, w)),
                              *_t(u, s0), _t(do)[0][:, :, :0], *_t(dS))
    assert all(t.shape[2] == 0 for t in empty[:4])
    assert not empty[4].any() and torch.equal(empty[5], _t(dS)[0])


def _rows(*xs, H):
    """(B, H, T, ·) → (B H, T, ·) rows, as the kernels take them."""
    return [None if x is None else x.reshape(-1, *x.shape[2:]) for x in xs]


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_fn_grads_match_autograd_of_chunked_ref(with_state,
                                                     monkeypatch):
    """The ``wkv6`` operator on CPU tensors: its outputs equal
    ``wkv6_chunked_ref``'s and its gradients autograd's through it,
    within 1e-5.  An unused final state sends no cotangent (the backward
    gets None, not zeros); dS_0 comes back exactly when the state requires
    grad."""
    B, H, T, K, V = 2, 2, 37, 16, 8
    r, k, v, w, u, s0, do, dS = _inputs(B, H, T, K, V, seed=5)
    xs = [t.requires_grad_() for t in _t(r, k, v, w, u)]
    st = _t(s0)[0].requires_grad_() if with_state else None
    seen = []
    plain_bwd = twkv6.wkv6_bwd_ref

    def spy(*args):
        seen.append(args[-1])
        return plain_bwd(*args)
    monkeypatch.setattr(twkv6, "wkv6_bwd_ref", spy)
    rr, kr, vr, wr, sr = _rows(*xs[:4], st, H=H)
    out, s = twkv6.wkv6_dev(rr, kr, vr, wr, xs[4], sr)
    ins = xs + ([st] if with_state else [])
    # the final state unused: no zero tensor is made for its cotangent
    g_out = torch.autograd.grad((out * _t(do)[0].reshape(out.shape)).sum(),
                                ins, retain_graph=True)
    assert seen == [None]
    g_both = torch.autograd.grad(
        (out * _t(do)[0].reshape(out.shape)).sum()
        + (s * _t(dS)[0].reshape(s.shape)).sum(), ins)
    assert seen[-1] is not None and len(seen) == 2

    ys = [t.detach().clone().requires_grad_() for t in _t(r, k, v, w, u)]
    sy = _t(s0)[0].requires_grad_() if with_state else None
    want_out, want_s = tref.wkv6_chunked_ref(*ys, sy)
    _close(out, want_out.reshape(out.shape), 1e-6, "out")
    _close(s, want_s.reshape(s.shape), 1e-6, "S_T")
    ins_y = ys + ([sy] if with_state else [])
    w_out = torch.autograd.grad((want_out * _t(do)[0]).sum(), ins_y,
                                retain_graph=True)
    w_both = torch.autograd.grad((want_out * _t(do)[0]).sum()
                                 + (want_s * _t(dS)[0]).sum(), ins_y)
    for got, want in ((g_out, w_out), (g_both, w_both)):
        assert len(got) == len(want) == (6 if with_state else 5)
        for name, a, b in zip(NAMES, got, want):
            _close(a, b.reshape(a.shape), 1e-5, name)
    # dS_0 only for a state that requires grad
    sr_nograd = _t(s0)[0].reshape(B * H, K, V)
    o2, _ = twkv6.wkv6_dev(rr, kr, vr, wr, xs[4], sr_nograd)
    grads = torch.autograd.grad(o2.sum(), xs)
    assert all(g is not None for g in grads)


#: (T, K, V, B*H): rwkv6-7b's train shape (a microbatch of 4 x 128) and
#: long shape, the smoke model's head, chip_smoke.py's WKV_EDGES; then the
#: padded head and columns, the steps of S a level-2 thread keeps, chunks
BWD_PLAN_SHAPES = {
    "train": (128, 64, 64, 256, (64, 64, 4, 8)),
    "long": (4096, 64, 64, 64, (64, 64, 4, 256)),
    "smoke": (16, 16, 16, 8, (64, 64, 4, 1)),
    "no steps": (0, 16, 8, 4, (64, 64, 4, 0)),
    "one step": (1, 8, 33, 3, (64, 64, 4, 1)),
    "wide head": (37, 72, 20, 2, (128, 64, 2, 3)),
    "wide head and V": (100, 128, 70, 1, (128, 128, 1, 7)),
    "wide V": (33, 16, 100, 2, (64, 128, 2, 3)),
}

#: shared memory of an H100 SM, and the most a block may use
SM_SMEM, BLOCK_SMEM = 228 * 1024, 227 * 1024


@pytest.mark.parametrize("label", sorted(BWD_PLAN_SHAPES))
def test_wkv6_bwd_plan(label):
    """Two levels over chunks of 16 steps.  Level 1: a block of 4 kk
    threads per (row, direction).  Level 2: a block of 512 threads per
    (chunk, row), each thread 32 floats of S history (``sub`` steps of its
    kk vv / 512 entries), two blocks an SM at 64 x 64 (shared memory for
    both, 1 KB reserved each).  The float32 scratch holds S at every chunk
    start and D at every chunk end (64 MiB at the train shape, 512 at the
    long one); no steps, no level 2."""
    T, K, V, BH, (kk, vv, sub, nc) = BWD_PLAN_SHAPES[label]
    p = wkv6_bwd_plan(T, K, V, BH)
    assert (p.kk, p.vv, p.sub, p.n_chunks, p.chunk) == (kk, vv, sub, nc, 16)
    assert p.n_chunks * p.chunk >= T > (p.n_chunks - 1) * p.chunk or T == 0
    assert p.states_grid == (BH, 2) and p.states_threads == 4 * kk <= 1024
    assert p.states_smem == 4 * 2 * (kk * 20 + 16 * (vv + 8) + kk)
    assert p.grid == (nc, BH) and p.threads == 512
    assert p.sub * kk * vv // 512 == 32
    assert max(p.states_smem, p.smem_bytes) <= BLOCK_SMEM
    assert p.blocks_per_sm == (2 if kk * vv == 4096 else 1)
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SM_SMEM
    assert p.scratch_bytes == 4 * 2 * BH * nc * kk * vv
    assert p.launches == (2 if T else 1)
    if label == "train":
        assert (p.smem_bytes, p.scratch_bytes) == (111616, 64 * 2**20)
    if label == "long":
        assert p.scratch_bytes == 512 * 2**20


def test_wkv6_bwd_plan_rejects_what_the_kernel_cannot_take():
    for shape in ((8, 12, 8, 4), (8, 136, 8, 4), (8, 64, 129, 4),
                  (8, 64, 8, 65536), (-1, 64, 8, 4), (8, 64, 0, 4)):
        with pytest.raises(ValueError):
            wkv6_bwd_plan(*shape)


@pytest.mark.parametrize("case,match", [
    ("do type", "do must be"),
    ("do shape", "do must be"),
    ("dS_T type", "dS_T must be"),
    ("wide V", "at most 128"),
    ("cpu tensors", "expected a tensor on"),
])
def test_wkv6_bwd_wrapper_raises_and_never_falls_back(case, match):
    """The backward's wrapper refuses what the kernel cannot take, and a
    well-formed call on CPU tensors raises at the device check instead of
    taking the plain version (the ``wkv6`` operator is the entry that
    does)."""
    BH, T, K, V = 4, 5, 16, 8
    r, k, w = (torch.zeros((BH, T, K), dtype=torch.bfloat16)
               for _ in range(3))
    v = torch.zeros((BH, T, V), dtype=torch.bfloat16)
    do, dS = torch.zeros_like(v), torch.zeros((BH, K, V))
    u = torch.zeros((2, K))
    if case == "do type":
        do = do.float()
    elif case == "do shape":
        do = do[:, :3]
    elif case == "dS_T type":
        dS = dS.double()
    elif case == "wide V":
        v = torch.zeros((BH, T, 136), dtype=torch.bfloat16)
        do, dS = torch.zeros_like(v), None
    with pytest.raises(ValueError, match=match):
        twkv6.wkv6_bwd_cuda(r, k, v, w, u, None, do, dS)
