"""The port's blockwise attention against the reference's, on the CPU.

``models.attention.flash_attention`` (through the ``attention`` operator,
which runs ``ref.attention_ref`` on CPU tensors), the operator itself and
``ref.attention_ref`` against ``repro.models.attention.flash_attention`` at
blocks of 16 (several blocks at T <= 64): causal GQA with G = 1, 2, 4,
non-causal with Tq != Tk, a ``q_offset``, ``kv_valid`` as a scalar and as
(B,) (the reference takes a (B,) limit only at B = 1, so it runs row by
row there), MLA's Dk != Dv with its scale, float32 and bf16.  Under a
sliding window the reference has NaN rows (a query block whose first key
block is wholly masked: exp(-inf + inf)); the test asserts they are there,
compares the port with the reference where the reference is finite and
with a dense float64 softmax everywhere.  Gradients: autograd of
``attention_ref`` against ``jax.grad`` of the reference, and the
operator's backward (``ref.attention_bwd_ref``, the plain twin of
``csrc/attention_bwd.cu``) against autograd of ``attention_ref``; under a
window against float64 autograd of the dense softmax.  Also the launch
plan's tiles, shared bytes and refusals, the fake implementations'
shapes, the FLOP formula against a count of the visited pairs, and the
wrappers' refusal of CPU tensors.  The CUDA kernels run only on the card
(``chip_smoke.py`` phase c holds them to the plain versions there).
Inputs come from seeded numpy generators.

Tolerances, each relative to 1 + the largest entry of the reference:
float32 outputs 1e-5 (the same blockwise float32 sums in torch's and XLA's
orders; measured at most 1e-6); bf16 outputs 2^-8 (both round a float32
result to bf16); gradients 1e-5 against ``jax.grad`` and 1e-5 between the
plain backward and autograd (float32 sums in other orders, measured at
most 1.4e-6); the float64 dense softmax 1e-5 for outputs and 1e-5 for
gradients (one float32 online softmax against float64).
"""
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import plan as kplan  # noqa: E402
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref  # noqa
from repro_torch.models.attention import flash_attention  # noqa: E402

BS = 16          # block_q = block_k: several blocks at test size
TOL32 = 1e-5
TOL_BF16 = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return n(B, Tq, Hq, D), n(B, Tk, Hkv, D), n(B, Tk, Hkv, Dv)


def _jfa(**kw):
    """The reference's ``flash_attention`` at blocks of BS, jitted (one
    compile a case rather than one a scan)."""
    kv = kw.pop("kv_valid", None)
    fn = functools.partial(jattn.flash_attention, block_q=BS, block_k=BS,
                           **kw)
    if kv is None:
        return jax.jit(fn)
    return jax.jit(lambda q, k, v: fn(q, k, v, kv_valid=jnp.asarray(kv)))


def _jref(q, k, v, **kw):
    out = _jfa(**kw)(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


def _dense64(q, k, v, *, causal=True, window=None, q_offset=0,
             kv_valid=None, scale=None):
    """Masked softmax attention in float64, all at once; a row that sees
    no key is 0."""
    q, k, v = (t.double() if isinstance(t, torch.Tensor)
               else torch.from_numpy(np.asarray(t, np.float64))
               for t in (q, k, v))
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    qp = q_offset + torch.arange(Tq)[:, None]
    kp = torch.arange(Tk)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    mask = mask[None, None].expand(B, 1, Tq, Tk)
    if kv_valid is not None:
        kv = torch.as_tensor(np.asarray(kv_valid)).reshape(-1, 1, 1, 1)
        mask = mask & (kp < kv)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _port(q, k, v, dtype=torch.float32, **kw):
    """(flash_attention, the operator's output, attention_ref's) as
    float32 numpy."""
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    scale = kw.get("scale")
    a = flash_attention(*t, block_q=BS, block_k=BS, **kw)
    kv = kw.get("kv_valid")
    kv_t = None if kv is None else torch.as_tensor(kv, dtype=torch.int32)\
        .reshape(-1).expand(q.shape[0]).contiguous()
    b, lse = kattn.attention_op(*t, kv_t, kw.get("causal", True),
                                kw.get("window"), kw.get("q_offset", 0),
                                scale if scale is not None
                                else 1 / math.sqrt(q.shape[-1]), BS, BS)
    c, _ = attention_ref(*t, block_q=BS, block_k=BS, **kw)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    return [x.float().numpy() for x in (a, b, c)]


def _close(got, want, tol):
    err = float(np.abs(got - want).max())
    assert err <= tol * (1 + float(np.abs(want).max())), err


# B, Tq, Tk, Hq, Hkv, D, Dv, keyword arguments
CASES = {
    "causal G=1": (2, 40, 40, 2, 2, 16, 16, {}),
    "causal G=2": (2, 40, 40, 4, 2, 16, 16, {}),
    "causal G=4": (1, 48, 48, 8, 2, 16, 16, {}),
    "non-causal Tq!=Tk": (2, 24, 56, 4, 2, 24, 8, {"causal": False}),
    "q_offset": (1, 20, 50, 4, 2, 16, 16, {"q_offset": 30}),
    "kv_valid scalar": (2, 20, 50, 4, 2, 16, 16,
                        {"q_offset": 30, "kv_valid": 41}),
    "mla Dk!=Dv": (2, 48, 48, 4, 4, 24, 16, {"scale": 24 ** -0.5 * 1.3}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_reference(case):
    B, Tq, Tk, Hq, Hkv, D, Dv, kw = CASES[case]
    q, k, v = _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed=len(case))
    want = _jref(q, k, v, **kw)
    assert np.isfinite(want).all()
    for got in _port(q, k, v, **kw):
        _close(got, want, TOL32)


@pytest.mark.parametrize("case", ["causal G=2", "mla Dk!=Dv",
                                  "non-causal Tq!=Tk"])
def test_port_matches_reference_bf16(case):
    B, Tq, Tk, Hq, Hkv, D, Dv, kw = CASES[case]
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed=3))
    want = np.asarray(_jfa(**kw)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))).astype(
            jnp.float32))
    for got in _port(q, k, v, torch.bfloat16, **kw):
        _close(got, want, TOL_BF16)


def test_mixed_types_meet_in_the_promoted_type():
    """A bf16 decoder's queries against float32 keys and values (the
    encoder-decoder's cross-attention): the reference promotes the
    products and casts the output to q's type; so does the port."""
    B, Tq, Tk, Hq, Hkv, D, Dv, kw = CASES["non-causal Tq!=Tk"]
    q, k, v = _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed=4)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(_jfa(**kw)(qb, jnp.asarray(k), jnp.asarray(v)).astype(
        jnp.float32))
    got = flash_attention(torch.from_numpy(np.asarray(qb.astype(
        jnp.float32))).bfloat16(), torch.from_numpy(k), torch.from_numpy(v),
        block_q=BS, block_k=BS, **kw)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, TOL_BF16)
    # the operator takes one type (its kernels do): traced on fake tensors,
    # where its checks run as on the card
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = flash_attention(torch.empty(B, Tq, Hq, D, dtype=torch.bfloat16),
                              torch.empty(B, Tk, Hkv, D),
                              torch.empty(B, Tk, Hkv, Dv), **kw)
        assert out.dtype == torch.bfloat16 and out.shape == (B, Tq, Hq, Dv)


def test_kv_valid_per_row():
    """A (B,) limit, row by row against the reference's scalar one."""
    B, Tq, Tk, Hq, Hkv, D = 2, 24, 64, 4, 2, 16
    q, k, v = _inputs(B, Tq, Tk, Hq, Hkv, D, D, seed=11)
    kv = np.array([64, 37], dtype=np.int32)
    got = _port(q, k, v, q_offset=40, kv_valid=kv)
    for b in range(B):
        want = _jref(q[b:b + 1], k[b:b + 1], v[b:b + 1], q_offset=40,
                     kv_valid=int(kv[b]))
        for g in got:
            _close(g[b:b + 1], want, TOL32)


@pytest.mark.parametrize("T,window", [(48, 20), (64, 40), (48, 16)])
def test_window_rows_are_the_masked_softmax(T, window):
    """The reference's NaN rows under a window are the masked softmax in
    the port; elsewhere the port is the reference."""
    q, k, v = _inputs(2, T, T, 4, 2, 16, 16, seed=T + window)
    want = _jref(q, k, v, window=window)
    nan_rows = ~np.isfinite(want).all(-1)
    assert nan_rows.any(), "the reference's windowed NaN rows are gone"
    dense = _dense64(q, k, v, window=window).numpy()
    for got in _port(q, k, v, window=window):
        assert np.isfinite(got).all()
        _close(got[~nan_rows], want[~nan_rows], TOL32)
        _close(got, dense, TOL32)


def _grads_torch(fn, q, k, v, do):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*t)
    return [g.numpy() for g in torch.autograd.grad(out, t,
                                                   torch.from_numpy(do))]


@pytest.mark.parametrize("case", ["causal G=2", "non-causal Tq!=Tk",
                                  "kv_valid scalar", "mla Dk!=Dv"])
def test_gradients_match_jax_grad(case):
    B, Tq, Tk, Hq, Hkv, D, Dv, kw = CASES[case]
    q, k, v = _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed=5)
    do = np.random.default_rng(6).normal(size=(B, Tq, Hq, Dv)).astype(
        np.float32)
    fa = _jfa(**kw)

    def loss(q_, k_, v_):
        return (fa(q_, k_, v_) * do).sum()
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    auto = _grads_torch(lambda *t: attention_ref(
        *t, block_q=BS, block_k=BS, **kw)[0], q, k, v, do)
    op = _grads_torch(lambda *t: flash_attention(
        *t, block_q=BS, block_k=BS, **kw), q, k, v, do)
    for a, o, w in zip(auto, op, want):
        _close(a, np.asarray(w), TOL32)
        _close(o, a, TOL32)


def test_window_gradients_match_dense_float64():
    q, k, v = _inputs(1, 64, 64, 4, 2, 16, 16, seed=9)
    do = np.random.default_rng(10).normal(size=(1, 64, 4, 16)).astype(
        np.float32)
    want = _grads_torch(lambda *t: _dense64(*t, window=20), q, k, v,
                        do.astype(np.float64))
    got = _grads_torch(lambda *t: flash_attention(
        *t, window=20, block_q=BS, block_k=BS), q, k, v, do)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _close(g, w, TOL32)


def test_backward_plain_version_reads_the_saved_rows():
    """``attention_bwd_ref`` from the forward's output and log-sum-exp is
    autograd of ``attention_ref``, rows that see no key included."""
    q, k, v = _inputs(2, 32, 48, 4, 2, 16, 8, seed=12)
    do = np.random.default_rng(13).normal(size=(2, 32, 4, 8)).astype(
        np.float32)
    kw = dict(q_offset=40, kv_valid=torch.tensor([48, 3], dtype=torch.int32),
              window=30, block_q=BS, block_k=BS)
    auto = _grads_torch(lambda *t: attention_ref(*t, **kw)[0], q, k, v, do)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = attention_ref(*t, **kw)
    assert torch.isneginf(lse[1]).all()         # batch row 1 sees no key
    assert torch.isfinite(lse[0]).all()
    got = attention_bwd_ref(*t, out, lse, torch.from_numpy(do), **kw)
    for g, a in zip(got, auto):
        assert torch.isfinite(g).all()
        _close(g.numpy(), a, TOL32)


# -- the launch plan, the fake implementations, the FLOP formula ------------

@pytest.mark.parametrize("D,Dv,G,width,gt,bq,bk,bn,smem,per_sm", [
    (64, 64, 4, 64, 4, 16, 64, 64, 69632, 2),        # llama3.2-1b
    (256, 256, 2, 256, 2, 32, 32, 32, 142336, 1),    # gemma3-12b
    (192, 128, 1, 192, 1, 64, 32, 32, 109568, 2),    # deepseek-v3 MLA
    (128, 128, 6, 128, 6, 10, 32, 64, 76800, 2),     # nemotron / dbrx
    (64, 256, 128, 256, 64, 1, 32, 32, 142336, 1),   # G past a tile's rows
    (16, 16, 2, 32, 2, 32, 64, 64, 45056, 2),        # the smoke configs
    (24, 16, 1, 32, 1, 64, 64, 64, 45056, 2),        # deepseek-v3 smoke MLA
])
def test_attention_plan(D, Dv, G, width, gt, bq, bk, bn, smem, per_sm):
    p = kplan.attention_plan(D, Dv, G)
    assert (p.width, p.gt, p.bq, p.bk, p.bn, p.threads) == \
        (width, gt, bq, bk, bn, 256)
    assert p.gt * p.bq <= kplan.ATTN_ROWS
    assert (p.smem_bytes, p.blocks_per_sm) == (smem, per_sm)
    r, ld = kplan.ATTN_ROWS, width + 4
    assert p.dq_smem == 4 * (2 * r * ld + 2 * bk * ld + r * (bk + 4) + 2 * r)
    assert p.dkdv_smem == 4 * (2 * bn * ld + 2 * r * ld + 2 * bn * (r + 4)
                               + 2 * r)
    assert max(p.smem_bytes, p.dq_smem, p.dkdv_smem) <= 232448
    assert p.dkdv_blocks_per_sm == 1
    assert p.grid(2, 100, 8, G) == (-(-100 // bq), 8 * -(-G // gt), 2)
    assert p.dkdv_grid(2, 100, 8) == (-(-100 // bn), 8, 2)
    assert kplan.attention_plan(D, Dv, G, 4) == p     # one plan, both types


@pytest.mark.parametrize("D,Dv,G,esz", [(30, 32, 1, 2), (64, 260, 1, 2),
                                        (0, 64, 1, 2), (64, 64, 0, 2),
                                        (64, 64, 1, 8)])
def test_attention_plan_refuses(D, Dv, G, esz):
    with pytest.raises(ValueError):
        kplan.attention_plan(D, Dv, G, esz)


def test_fake_implementations_give_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 4096, 16, 256, dtype=torch.bfloat16)
        k = torch.empty(2, 4096, 8, 256, dtype=torch.bfloat16)
        v = torch.empty(2, 4096, 8, 128, dtype=torch.bfloat16)
        out, lse = kattn.attention_op(q, k, v, None, True, 1024, 0, 0.1,
                                      512, 512)
        assert out.shape == (2, 4096, 16, 128) and out.dtype == q.dtype
        assert lse.shape == (2, 16, 4096) and lse.dtype == torch.float32
        dq, dk, dv = kattn.attention_bwd_op(q, k, v, out, lse, out, None,
                                            True, 1024, 0, 0.1, 512, 512)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        with pytest.raises(ValueError):
            kattn.attention_op(q, k[:, :, :3], v, None, True, None, 0, 0.1,
                               512, 512)


def _visited_pairs(Tq, Tk, causal, window, q_offset, bq, bk):
    """Pairs the reference's scan visits, counted block by block."""
    bq, bk = min(bq, Tq), min(bk, Tk)
    nk = -(-Tk // bk)
    total = 0
    for i in range(-(-Tq // bq)):
        lo = max(0, (q_offset + i * bq - window) // bk) if window else 0
        hi = min(nk, (q_offset + (i + 1) * bq + bk - 1) // bk) if causal \
            else nk
        total += bq * bk * max(hi - lo, 1)
    return total


@pytest.mark.parametrize("Tq,Tk,causal,window,q_offset", [
    (96, 96, True, None, 0), (96, 96, True, 20, 0), (24, 56, False, None, 0),
    (20, 50, True, None, 30), (33, 33, True, 5, 0)])
def test_flop_formula_counts_the_visited_pairs(Tq, Tk, causal, window,
                                               q_offset):
    from torch.utils.flop_counter import FlopCounterMode
    B, Hq, Hkv, D, Dv = 2, 4, 2, 16, 8
    pairs = B * Hq * _visited_pairs(Tq, Tk, causal, window, q_offset, BS,
                                    BS)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(
        B, Tq, Tk, Hq, Hkv, D, Dv, seed=1))
    with FlopCounterMode(display=False) as fc:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, block_q=BS, block_k=BS)
    assert fc.get_total_flops() == 2 * pairs * (D + Dv)
    with FlopCounterMode(display=False) as fc:
        out.sum().backward()
    assert fc.get_total_flops() == 2 * pairs * (2 * D + 2 * Dv)
    # the exact masked pairs, which the card's bound reads, are fewer
    exact = kplan.attention_masked_pairs(Tq, Tk, causal, window, q_offset)
    qp = q_offset + np.arange(Tq)[:, None]
    kp = np.arange(Tk)[None, :]
    m = np.ones((Tq, Tk), bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > qp - window
    assert exact == int(m.sum()) <= pairs // (B * Hq)


def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    kernels.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 64)
    flash_attention(q, q, q)
    with pytest.raises(ValueError):
        kattn.attention_cuda(q, q, q, None, True, None, 0, 0.125)
    with pytest.raises(ValueError):
        kattn.attention_cuda(q[..., :30], q[..., :30], q[..., :30], None,
                             True, None, 0, 0.125)
    counts = kernels.launch_counts()
    assert counts["attention"] == counts["attention_bwd"] == 0
