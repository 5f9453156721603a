"""The tensor-core attention forward's plain twin and launch plan, on the
CPU.

``ref.attention_mma_ref`` is the plain twin of ``csrc/attention_mma.cu``,
the bf16 forward on ``wgmma``: keys in the kernel's aligned steps of
``bk``, P entering P V as two bf16 parts (hi + lo), float32 sums.  It is
held to the reference's ``repro.models.attention.flash_attention``
(jitted, blocks of 16, on bf16 inputs from seeded numpy) at the head
sizes the published configs run in bf16 -- 64, 128, MLA's 192 / 128 and
256 -- and G = 1, 2, 6 and 16 query heads a kv head: a ragged T that is
no multiple of a step, a window that crosses steps, ``kv_valid`` as (B,)
(row by row: the reference takes a (B,) limit only at B = 1), a
``q_offset``, and non-causal attention with Tq != Tk.  Under a window the
reference has NaN rows (a query block whose first key block is wholly
masked); there the twin is compared with a dense float64 softmax.  The
tolerance is the card's gate on the kernel, unchanged: 2^-8 x (1 + max
|ref|) (both round a float32 result to bf16).  P as one bf16 part misses
it at a row that sees 3 keys (shown below); the two parts keep it.  Also:
the twin beside the port's float32-P ``attention_ref`` at the same gate,
``attention_mma_plan``'s tiles, shared bytes, registers, residency and
refusals, the route a call of each type and head size takes, what the
wrapper hands the kernel's C entry point (a stand-in library on CPU
tensors), and that a failed launch raises with no other kernel called.
The kernel itself runs only on the card (``chip_smoke.py`` phase c).
"""
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import plan as kplan  # noqa: E402
from repro_torch.kernels.ref import attention_mma_ref, attention_ref  # noqa

BS = 16
TOL_BF16 = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed):
    """bf16-exact float32 numpy inputs."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return n(B, Tq, Hq, D), n(B, Tk, Hkv, D), n(B, Tk, Hkv, Dv)


@functools.lru_cache(maxsize=None)
def _jfa(causal, window, q_offset, kv, scale):
    return jax.jit(functools.partial(
        jattn.flash_attention, block_q=BS, block_k=BS, causal=causal,
        window=window, q_offset=q_offset, scale=scale,
        **({} if kv is None else {"kv_valid": jnp.asarray(kv)})))


def _jref(q, k, v, causal=True, window=None, q_offset=0, kv=None,
          scale=None):
    """The reference in bf16, as float32 numpy."""
    out = _jfa(causal, window, q_offset, kv, scale)(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    return np.asarray(out.astype(jnp.float32))


def _dense64(q, k, v, causal=True, window=None, q_offset=0, kv=None,
             scale=None):
    """Masked softmax attention in float64, all at once; a row that sees
    no key is 0."""
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    qp = q_offset + torch.arange(Tq)[:, None]
    kp = torch.arange(Tk)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if kv is not None:
        mask &= kp < kv
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).numpy()


def _twin(q, k, v, **kw):
    kv = kw.pop("kv", None)
    if kv is not None:
        kw["kv_valid"] = torch.as_tensor(kv, dtype=torch.int32)
    out, lse = attention_mma_ref(*(torch.from_numpy(x).bfloat16()
                                   for x in (q, k, v)), **kw)
    assert out.dtype == torch.bfloat16
    return out.float().numpy(), lse


def _err(got, want):
    return float(np.abs(got - want).max()) / (1 + float(np.abs(want).max()))


# B, Tq, Tk, Hq, Hkv, D, Dv, keyword arguments: each width with one G of
# 1, 2, 6, 16, and each edge at least once
CASES = {
    "64 G=2 ragged": (1, 150, 150, 4, 2, 64, 64, {}),
    "64 G=16 q_offset": (1, 40, 90, 16, 1, 64, 64, {"q_offset": 50}),
    "128 G=6 window": (1, 140, 140, 6, 1, 128, 128, {"window": 70}),
    "128 G=2 non-causal": (1, 24, 200, 4, 2, 128, 128, {"causal": False}),
    "192/128 G=1 mla": (2, 70, 70, 2, 2, 192, 128,
                        {"scale": 192 ** -0.5 * 1.3}),
    "256 G=2 window": (1, 150, 150, 4, 2, 256, 256, {"window": 40}),
    "256 G=1 ragged": (1, 70, 70, 1, 1, 256, 256, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_reference(case):
    B, Tq, Tk, Hq, Hkv, D, Dv, kw = CASES[case]
    q, k, v = _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed=len(case))
    want = _jref(q, k, v, **kw)
    got, lse = _twin(q, k, v, **kw)
    assert np.isfinite(got).all() and torch.isfinite(lse).all()
    fin = np.isfinite(want).all(-1)
    if "window" in kw:
        assert not fin.all(), "the reference's windowed NaN rows are gone"
        assert _err(got, _dense64(q, k, v, **kw)) <= TOL_BF16
    assert _err(got[fin], want[fin]) <= TOL_BF16


def test_twin_kv_valid_per_row():
    """A (B,) limit, one row seeing 3 keys, row by row against the
    reference's scalar one.  There P rounded to one bf16 part moves an
    output by a bf16 step past the gate: the kernel's second part is what
    keeps it."""
    B, Tq, Tk, Hq, Hkv, D = 2, 19, 150, 16, 1, 64
    q, k, v = _inputs(B, Tq, Tk, Hq, Hkv, D, D, seed=11)
    kv = np.array([150, 3], dtype=np.int32)
    got, lse = _twin(q, k, v, q_offset=131, kv=kv)
    one, _ = _twin(q, k, v, q_offset=131, kv=kv, p_parts=1)
    for b in range(B):
        want = _jref(q[b:b + 1], k[b:b + 1], v[b:b + 1], q_offset=131,
                     kv=int(kv[b]))
        assert _err(got[b:b + 1], want) <= TOL_BF16
    assert _err(one[1:], want) > TOL_BF16
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("case", ["64 G=2 ragged", "128 G=6 window",
                                  "192/128 G=1 mla", "256 G=2 window"])
def test_bf16_p_keeps_the_gate_against_float32_p(case):
    """The twin beside the port's float32-P blockwise attention on the
    same bf16 inputs: the P rounding stays inside the unchanged gate, and
    the log-sum-exp (which reads no P) within 1e-4, -inf rows alike."""
    B, Tq, Tk, Hq, Hkv, D, Dv, kw = CASES[case]
    t = [torch.from_numpy(x).bfloat16()
         for x in _inputs(B, Tq, Tk, Hq, Hkv, D, Dv, seed=7)]
    want, want_lse = attention_ref(*t, **kw)
    got, lse = attention_mma_ref(*t, **kw)
    assert _err(got.float().numpy(), want.float().numpy()) <= TOL_BF16
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse - want_lse)[fin].abs().max()) <= 1e-4


def test_twin_without_keys():
    """Tk = 0, and keys that no row can see: rows of 0, log-sum-exp -inf."""
    q, k, v = (torch.randn(s).bfloat16() for s in
               ((1, 9, 2, 64), (1, 0, 1, 64), (1, 0, 1, 64)))
    out, lse = attention_mma_ref(q, k, v, causal=False)
    assert out.shape == (1, 9, 2, 64) and not out.any()
    assert torch.isneginf(lse).all()
    k, v = torch.randn(1, 40, 1, 64).bfloat16(), torch.randn(
        1, 40, 1, 64).bfloat16()
    out, lse = attention_mma_ref(q, k, v, kv_valid=torch.zeros(
        1, dtype=torch.int32))
    assert not out.any() and torch.isneginf(lse).all()


def test_twin_rows_do_not_depend_on_the_query_blocks():
    """Keys step at multiples of bk whatever the query block, so a row
    meets the same steps in any block (torch may order a sum's terms by
    the block's shape: equal to 1e-6)."""
    t = [torch.from_numpy(x).bfloat16()
         for x in _inputs(1, 130, 130, 4, 2, 64, 64, seed=3)]
    a = attention_mma_ref(*t, window=50, block_q=1024)
    b = attention_mma_ref(*t, window=50, block_q=7)
    assert float((a[0].float() - b[0].float()).abs().max()) <= 1e-6
    assert float((a[1] - b[1]).abs().max()) <= 1e-6


# -- the launch plan and the route ---------------------------------------

@pytest.mark.parametrize("D,Dv,G,dc,vc,rows,gt,bq,bk,stages,smem", [
    (64, 64, 4, 1, 1, 192, 4, 48, 96, 4, 123904),         # llama3.2-1b
    (128, 128, 6, 2, 2, 128, 6, 21, 128, 2, 164864),      # nemotron / dbrx
    (192, 128, 1, 3, 2, 128, 1, 128, 64, 3, 173056),      # deepseek-v3 MLA
    (256, 256, 2, 4, 4, 128, 2, 64, 64, 2, 197632),       # gemma3-12b
    (192, 192, 16, 3, 3, 128, 16, 8, 64, 3, 197632),
    (64, 256, 6, 4, 4, 128, 6, 21, 64, 2, 197632),        # the larger's square
    (48, 48, 128, 1, 1, 192, 128, 1, 96, 4, 123904),      # G past a tile's
    (64, 64, 200, 1, 1, 192, 192, 1, 96, 4, 123904),      # two head chunks
])
def test_attention_mma_plan(D, Dv, G, dc, vc, rows, gt, bq, bk, stages,
                            smem):
    p = kplan.attention_mma_plan(D, Dv, G)
    nwg = rows // 64
    assert (p.dc, p.vc, p.rows, p.gt, p.bq, p.bk, p.stages, p.threads) == \
        (dc, vc, rows, gt, bq, bk, stages, 128 * (nwg + 1))
    assert p.gt * p.bq <= p.rows
    assert p.smem_bytes == smem == (1024 + dc * rows * 128
                                    + stages * (dc + vc) * bk * 128)
    assert smem <= kplan.ATTN_MMA_SMEM_BUDGET < 232448
    assert p.blocks_per_sm == 1
    # ptxas grants 65 536 / threads registers a thread (a multiple of 8):
    # the producers keep 24, the consumers take the rest (at most 255)
    assert p.regs == 65536 // p.threads // 8 * 8 == (168 if nwg == 2
                                                     else 128)
    assert p.consumer_regs == (240 if nwg == 2 else 160)
    assert 128 * nwg * p.consumer_regs + 128 * 24 <= p.threads * p.regs
    assert p.blocks(2, 100, 8, G) == (-(-100 // bq) * 8 * -(-G // gt) * 2)


@pytest.mark.parametrize("D,Dv,G,esz", [
    (64, 64, 4, 4),        # float32
    (32, 32, 2, 2),        # width 32
    (16, 32, 1, 2),
    (72, 72, 1, 2),        # not a multiple of 16
    (64, 264, 1, 2),       # past 256
    (64, 64, 0, 2)])
def test_attention_mma_plan_refuses(D, Dv, G, esz):
    with pytest.raises(ValueError):
        kplan.attention_mma_plan(D, Dv, G, esz)


@pytest.mark.parametrize("dt,D,Dv,route", [
    (torch.bfloat16, 64, 64, "mma"), (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 192, 128, "mma"), (torch.bfloat16, 256, 256, "mma"),
    (torch.bfloat16, 48, 16, "mma"), (torch.float32, 64, 64, "simt"),
    (torch.bfloat16, 16, 16, "simt"), (torch.bfloat16, 24, 16, "simt"),
    (torch.bfloat16, 72, 72, "simt")])
def test_route_follows_type_and_head_sizes(dt, D, Dv, route):
    assert kattn.attention_route(dt, D, Dv) == route


# -- what the wrapper hands the C entry points -----------------------------

class _Recorder:
    """A stand-in library whose entry points record their arguments and
    return ``code`` (0: a launch that succeeded)."""

    def __init__(self, code=0):
        self.calls, self.code = [], code
        for name in ("repro_attention", "repro_attention_mma"):
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.code
        return call


def _on_the_card(monkeypatch, lib):
    monkeypatch.setattr(kattn, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kattn, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(kattn._build, "library", lambda name: lib)


def _qkv(dt, B=1, T=40, Hq=8, Hkv=2, D=64, Dv=64):
    return (torch.zeros(B, T, Hq, D, dtype=dt),
            torch.zeros(B, T, Hkv, D, dtype=dt),
            torch.zeros(B, T, Hkv, Dv, dtype=dt))


@pytest.mark.parametrize("dt,D,Dv,route,entry", [
    (torch.bfloat16, 64, 64, None, "repro_attention_mma"),
    (torch.bfloat16, 192, 128, None, "repro_attention_mma"),
    (torch.bfloat16, 64, 64, "simt", "repro_attention"),
    (torch.float32, 64, 64, None, "repro_attention"),
    (torch.bfloat16, 16, 16, None, "repro_attention")])
def test_wrapper_launches_its_route_on_its_plan(monkeypatch, dt, D, Dv,
                                                route, entry):
    lib = _Recorder()
    _on_the_card(monkeypatch, lib)
    counts = (kattn.LAUNCHES, kattn.MMA_LAUNCHES, kattn.SIMT_LAUNCHES)
    kattn.attention_cuda(*_qkv(dt, D=D, Dv=Dv), None, True, None, 0, 0.125,
                         route=route)
    (name, args), = lib.calls
    assert name == entry
    mma = entry == "repro_attention_mma"
    if mma:
        p = kplan.attention_mma_plan(D, Dv, 4)
        assert args[18:28] == (p.dc, p.vc, p.rows, p.gt, p.bq, p.bk,
                               p.stages, p.threads, p.smem_bytes,
                               p.blocks_per_sm)
    else:
        p = kplan.attention_plan(D, Dv, 4)
        assert args[19:26] == (p.width, p.gt, p.bq, p.bk, p.threads,
                               p.smem_bytes, p.blocks_per_sm)
    assert (kattn.LAUNCHES, kattn.MMA_LAUNCHES, kattn.SIMT_LAUNCHES) == (
        counts[0] + 1, counts[1] + mma, counts[2] + (not mma))


def test_wrapper_raises_and_never_falls_back(monkeypatch):
    """A refused launch of the tensor-core kernel reaches the caller; the
    SIMT kernel is not called in its place, and nothing is counted."""
    lib = _Recorder(code=1)
    _on_the_card(monkeypatch, lib)
    counts = (kattn.LAUNCHES, kattn.MMA_LAUNCHES, kattn.SIMT_LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        kattn.attention_cuda(*_qkv(torch.bfloat16), None, True, None, 0,
                             0.125)
    assert [n for n, _ in lib.calls] == ["repro_attention_mma"]
    assert (kattn.LAUNCHES, kattn.MMA_LAUNCHES,
            kattn.SIMT_LAUNCHES) == counts
    with pytest.raises(ValueError):     # float32 has no tensor-core route
        kattn.attention_cuda(*_qkv(torch.float32), None, True, None, 0,
                             0.125, route="mma")
