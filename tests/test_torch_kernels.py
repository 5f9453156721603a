"""The port's kernel layer (``repro_torch.kernels.ops``) against the
reference's (``repro.kernels.ops`` in Pallas interpret mode, its XLA twins
and ``repro.kernels.ref``).

On this CPU the port's wrappers run their plain-torch versions (the CUDA
kernels themselves are held against those same plain versions on the card
by ``chip_smoke.py``).  Inputs are made from seeds with numpy and handed to
both packages.
"""
import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import mds as jmds  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import mds as tmds  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the driver runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (37, 70, 129), (128, 256, 64),
                                   (200, 131, 3)])
def test_matmul_matches_reference(M, K, N):
    """f32 at 2e-3 (the reference's own kernel tolerance) over ragged
    shapes: no padding in, the same shape out."""
    rng = np.random.default_rng(M * 7 + K)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    ours = tops.matmul(_t(a), _t(b)).numpy()
    theirs = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    assert ours.shape == (M, N)
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        ours, np.asarray(jref.matmul_ref(jnp.asarray(a), jnp.asarray(b))),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("L,S,B", [(5, 7, None), (130, 64, 3), (256, 300, 1)])
def test_coded_matvec_matches_reference(L, S, B):
    rng = np.random.default_rng(L + S)
    a = rng.normal(size=(L, S)).astype(np.float32)
    x = rng.normal(size=(S,) if B is None else (S, B)).astype(np.float32)
    ours = tops.coded_matvec(_t(a), _t(x)).numpy()
    theirs = np.asarray(jops.coded_matvec(jnp.asarray(a), jnp.asarray(x),
                                          interpret=True))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ours, np.asarray(jref.coded_matvec_ref(jnp.asarray(a),
                                                jnp.asarray(x))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L,Lt,S", [(100, 250, 333), (128, 256, 128),
                                    (60, 60, 70)])
def test_mds_encode_matches_reference(L, Lt, S):
    """The reference's ragged sweep (``tests/test_kernels.py``): float32
    against its interpret-mode kernel at its 2e-3, float64 against
    ``G @ A`` at 1e-12; the systematic prefix is A itself, bit for bit."""
    rng = np.random.default_rng(L + Lt + S)
    G = rng.normal(0, 1 / np.sqrt(L), size=(Lt, L))
    G[:L] = np.eye(L)
    A = rng.normal(size=(L, S))
    G32, A32 = G.astype(np.float32), A.astype(np.float32)
    ours = tops.mds_encode(_t(G32), _t(A32)).numpy()
    theirs = np.asarray(jops.mds_encode(jnp.asarray(G32), jnp.asarray(A32),
                                        interpret=True))
    assert ours.shape == (Lt, S) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(ours[:L], A32)
    ours64 = tops.mds_encode(_t(G), _t(A)).numpy()
    assert ours64.dtype == np.float64
    np.testing.assert_allclose(ours64, G @ A, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ours64[:L], A)
    full = tops.mds_encode(_t(G), _t(A), systematic=False).numpy()
    np.testing.assert_allclose(full, G @ A, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shared", [True, False])
def test_mds_encode_batch_shared_and_per_task_generators(shared):
    rng = np.random.default_rng(21)
    B, L, Lt, S = 3, 40, 90, 17
    G = rng.normal(0, 1 / np.sqrt(L), size=(Lt, L) if shared
                   else (B, Lt, L))
    G[..., :L, :] = np.eye(L)
    A = rng.normal(size=(B, L, S))
    G32, A32 = G.astype(np.float32), A.astype(np.float32)
    ours = tops.mds_encode_batch(_t(G32), _t(A32)).numpy()
    theirs = np.asarray(jops.mds_encode_batch(
        jnp.asarray(G32), jnp.asarray(A32), interpret=True))
    assert ours.shape == (B, Lt, S)
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(ours[:, :L], A32)
    ours64 = tops.mds_encode_batch(_t(G), _t(A)).numpy()
    np.testing.assert_allclose(ours64, np.matmul(G, A), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("C", [None, 3])
def test_coded_matvec_batch_matches_reference(C):
    """(B, L, S) × (B, S) or (B, S, C): float32 against the reference's
    vmapped interpret-mode kernel, float64 against numpy at 1e-12."""
    rng = np.random.default_rng(22 + (C or 0))
    B, L, S = 3, 70, 33
    A = rng.normal(size=(B, L, S))
    x = rng.normal(size=(B, S) if C is None else (B, S, C))
    ours = tops.coded_matvec_batch(_t(A.astype(np.float32)),
                                   _t(x.astype(np.float32))).numpy()
    theirs = np.asarray(jops.coded_matvec_batch(
        jnp.asarray(A, jnp.float32), jnp.asarray(x, jnp.float32),
        interpret=True))
    assert ours.shape == theirs.shape == ((B, L) if C is None else (B, L, C))
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)
    want = np.einsum("bls,bs->bl", A, x) if C is None \
        else np.einsum("bls,bsc->blc", A, x)
    for got in (tops.coded_matvec_batch(_t(A), _t(x)),
                tref.coded_matvec_batch_ref(_t(A), _t(x))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


def test_coded_shard_matmul_batch_matches_reference():
    rng = np.random.default_rng(3)
    tiles = rng.normal(size=(3, 128, 128)).astype(np.float32)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    ours = tops.coded_shard_matmul_batch(_t(tiles), _t(x)).numpy()
    theirs = np.asarray(jops.coded_shard_matmul_batch(
        jnp.asarray(tiles), jnp.asarray(x), mode="pallas", interpret=True))
    assert ours.shape == (3, 128, 4)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 100, 128), (2, 128, 96)])
def test_coded_shard_matmul_batch_rejects_unaligned_tiles(shape):
    tiles = torch.zeros(shape)
    x = torch.zeros((shape[2], 2))
    with pytest.raises(ValueError, match="block-aligned"):
        tops.coded_shard_matmul_batch(tiles, x)
    with pytest.raises(ValueError, match="block-aligned"):
        jops.coded_shard_matmul_batch(jnp.asarray(tiles.numpy()),
                                      jnp.asarray(x.numpy()), mode="pallas",
                                      interpret=True)


@pytest.mark.parametrize("L", [200, 512])
def test_counter_parity_rows_bit_equal(L):
    key = (0xDEADBEEF, 41)
    ctrs = jmds.parity_counters(np.array([0, 3, 129, 500]), [0, 1, 0, 2])
    host = jmds.counter_parity_rows(key, ctrs, L, dtype=np.float32)
    ours = tops.counter_parity_rows(key, L, ctrs, device="cpu").numpy()
    assert ours.dtype == np.float32
    assert np.array_equal(host, ours)
    # the port's own host copy of the derivation agrees too
    assert np.array_equal(
        tmds.counter_parity_rows(key, ctrs, L, dtype=np.float32), host)
    # and the reference's kernel, in interpret mode
    assert np.array_equal(
        np.asarray(jops.counter_parity_rows(key, L, ctrs, interpret=True)),
        host)


def test_counter_parity_rows_column_subsets_bit_equal():
    """Decode minors ask for arbitrary column subsets: the entries are the
    same bits as the matching columns of the full rows."""
    key = (7, 0x9E3779B9)
    L = 300
    ctrs = jmds.parity_counters(np.arange(40, 57), 3)
    full = jmds.counter_parity_rows(key, ctrs, L, dtype=np.float32)
    cols = np.random.default_rng(4).permutation(L)[:77]
    ours = tops.counter_parity_rows(key, L, ctrs, cols=cols,
                                    device="cpu").numpy()
    assert np.array_equal(ours, full[:, cols])


def test_counter_parity_rows_extreme_counters():
    """uint32 wrap-around: counters with the top bit set and column ids
    whose doubled value wraps."""
    key = (0xFFFFFFFF, 0x80000001)
    ctrs = np.array([0xFFFFFFFF, 0x80000000, 0], dtype=np.uint32)
    cols = np.array([0, 1, 0x7FFFFFFF, 0x80000001, 0xFFFFFFFF],
                    dtype=np.uint32)
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    want = jmds.counter_gaussian_tile(k0, k1, ctrs[:, None], cols[None, :],
                                      np.float32(np.sqrt(3.0 / 64)))
    got = tref.counter_parity_rows_ref(key, float(np.float32(np.sqrt(3 / 64))),
                                       _t(ctrs.astype(np.int64)),
                                       _t(cols.astype(np.int64))).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("C", [1, 4, 11, 32, 64])
def test_parity_contract_matches_reference_rows(C, monkeypatch):
    """R[ctrs][:, cols] @ Z, the decode's substitution term, against the
    reference's rows gathered at random columns times a float64 Z; the
    plain version derives R in row chunks (small ones here, so several)."""
    monkeypatch.setattr(tref, "_CHUNK", 256)
    rng = np.random.default_rng(31 + C)
    key, L = (0xC0FFEE, 0x9E3779B9), 300
    ctrs = jmds.parity_counters(np.arange(5, 45), [0, 1, 2, 200] * 10)
    cols = rng.permutation(L)[:97]
    z = rng.normal(size=(cols.size, C))
    want = jmds.counter_parity_rows(key, ctrs, L)[:, cols].astype(
        np.float64) @ z
    got = tops.parity_contract(key, L, ctrs, _t(z), cols=cols)
    assert got.dtype == torch.float64 and got.shape == (ctrs.size, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * (1 + np.abs(want).max()))
    # no cols: columns 0..L-1
    zf = rng.normal(size=(L, C))
    np.testing.assert_allclose(
        tops.parity_contract(key, L, ctrs, _t(zf)).numpy(),
        jmds.counter_parity_rows(key, ctrs, L).astype(np.float64) @ zf,
        rtol=0, atol=1e-12 * (1 + np.abs(want).max()))


def test_parity_contract_rejects_what_the_kernel_cannot_take():
    """The wrapper checks its operands before it picks a path, so a
    mismatch raises on every device (no path falls back)."""
    ctrs = torch.arange(3)
    cols = torch.arange(5)
    with pytest.raises(ValueError, match="float64"):
        tops.parity_contract((1, 2), 8, ctrs, torch.ones(5, 2), cols=cols)
    with pytest.raises(ValueError, match="4 columns for z of 5 rows"):
        tops.parity_contract((1, 2), 8, ctrs,
                             torch.ones(5, 2, dtype=torch.float64),
                             cols=cols[:4])
    with pytest.raises(ValueError, match="z of 5 rows for the 8 columns"):
        tops.parity_contract((1, 2), 8, ctrs,
                             torch.ones(5, 2, dtype=torch.float64))
    # operands on two devices (``ops`` moves host counters to z's device;
    # the kernel wrapper takes tensors as they lie)
    from repro_torch.kernels.mds_encode import parity_contract_dev
    with pytest.raises(ValueError, match="expected a tensor on cpu"):
        parity_contract_dev((1, 2), 0.5, torch.arange(3, device="meta"),
                            cols, torch.ones(5, 2, dtype=torch.float64))


_U24 = st.integers(0, 2 ** 24 - 1)


@settings(max_examples=400, deadline=None)
@given(_U24, _U24, _U24, _U24)
@example(0, 0, 0, 0)
@example(2 ** 24 - 1, 2 ** 24 - 1, 2 ** 24 - 1, 2 ** 24 - 1)
@example(2 ** 24 - 1, 1, 0, 2 ** 23 + 1)
def test_integer_pair_sums_give_the_entry_bits(a0, a1, b0, b1):
    """The kernels' parity entry: u(a0) + u(a1) with u(v) = v * 2^-24 of
    the 24-bit values equals one round-to-nearest conversion of the
    integer a0 + a1, scaled; and (pair sum) * 2^-24 - 2 rounds once, so
    it is one fma.  Bit for bit, in numpy float32."""
    f, s24 = np.float32, np.float32(2.0 ** -24)
    old = ((f(a0) * s24 + f(a1) * s24) + (f(b0) * s24 + f(b1) * s24)) - f(2)
    s = f(a0 + a1) + f(b0 + b1)
    new = f(np.float64(s) * 2.0 ** -24 - 2.0)      # fma: one rounding
    assert old.dtype == new.dtype == np.float32
    assert old.view(np.uint32) == new.view(np.uint32)


def test_gen_parity_products_matches_xla_twin():
    rng = np.random.default_rng(5)
    L, D, C = 96, 40, 3
    key = (123, 456)
    ctrs = jmds.parity_counters(np.arange(7), 0)
    w = rng.normal(size=(L, D)).astype(np.float32)
    x = rng.normal(size=(D, C)).astype(np.float32)
    theirs = np.asarray(jops.gen_parity_products(
        key, ctrs, jnp.asarray(w), jnp.asarray(x), interpret=True))
    ours = tops.gen_parity_products(key, ctrs, _t(w), _t(x)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)
    # x padded beyond D (the packed tiles' layout) contracts the same
    xp = np.zeros((128, C), np.float32)
    xp[:D] = x
    np.testing.assert_array_equal(
        tops.gen_parity_products(key, ctrs, _t(w), _t(xp)).numpy(), ours)


def test_generated_lanes_in_shard_batch():
    """parity_mode="generated": parity lanes come from the generator,
    every other lane from the tiles."""
    rng = np.random.default_rng(6)
    L, D = 64, 128
    w = rng.normal(size=(L, D)).astype(np.float32)
    tiles = rng.normal(size=(1, 128, D)).astype(np.float32)
    lanes = np.array([3, 70, 127])
    tiles[0, lanes] = 0.0
    x = rng.normal(size=(D, 2)).astype(np.float32)
    ctrs = jmds.parity_counters(np.array([0, 5, 9]), 0)
    spec = tops.GeneratedParity(lanes=lanes, ctrs=ctrs, key=(1, 2), w=_t(w))
    out = tops.coded_shard_matmul_batch(_t(tiles), _t(x),
                                        parity_mode="generated",
                                        parity=[spec]).numpy()[0]
    R = jmds.counter_parity_rows((1, 2), ctrs, L)
    np.testing.assert_allclose(out[lanes], R @ (w.astype(np.float64) @ x),
                               rtol=1e-4, atol=1e-4)
    rest = np.setdiff1d(np.arange(128), lanes)
    np.testing.assert_allclose(out[rest], tiles[0, rest] @ x, rtol=1e-4,
                               atol=1e-4)


def test_double_output_products_are_float64_exact():
    """The head repair: float32 tiles, weights and activations multiply
    exactly in float64 and sum in float64 — both the packed-tile product
    and the generated-parity lanes agree with a float64 numpy product of
    the same float32 values at 1e-12 (float32 sums miss it by ~1e-6)."""
    rng = np.random.default_rng(23)
    L, D = 64, 128
    w = rng.normal(size=(L, D)).astype(np.float32)
    tiles = rng.normal(size=(2, 128, D)).astype(np.float32)
    lanes = np.array([3, 70, 200])
    tiles.reshape(-1, D)[lanes] = 0.0
    x = rng.normal(size=(D, 4)).astype(np.float32)
    ctrs = jmds.parity_counters(np.array([0, 5, 9]), 0)
    spec = tops.GeneratedParity(lanes=lanes, ctrs=ctrs, key=(1, 2), w=_t(w))
    out = tops.coded_shard_matmul_batch(_t(tiles), _t(x),
                                        parity_mode="generated",
                                        parity=[spec])
    assert out.dtype == torch.float64
    out = out.numpy().reshape(-1, 4)
    x64 = x.astype(np.float64)
    want = tiles.reshape(-1, D).astype(np.float64) @ x64
    R = jmds.counter_parity_rows((1, 2), ctrs, L)          # float32 values
    want[lanes] = R.astype(np.float64) @ (w.astype(np.float64) @ x64)
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
    f32 = tops.coded_shard_matmul_batch(_t(tiles), _t(x),
                                        parity_mode="generated",
                                        parity=[spec],
                                        out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy().reshape(-1, 4), want, rtol=1e-4,
                               atol=1e-4)


def test_launch_counts_stay_zero_on_cpu():
    """The plain versions are not kernel launches."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    tops.matmul(torch.ones(4, 4), torch.ones(4, 4))
    tops.counter_parity_rows((1, 2), 8, np.arange(3), device="cpu")
    tops.parity_contract((1, 2), 8, np.arange(3),
                         torch.ones(8, 2, dtype=torch.float64))
    tops.mds_encode_batch(torch.ones(5, 3, dtype=torch.float64),
                          torch.ones(2, 3, 4, dtype=torch.float64))
    tops.coded_matvec_batch(torch.ones(2, 3, 4), torch.ones(2, 4))
    tops.wkv6(*(torch.ones(2, 5, 8) for _ in range(4)), torch.ones(8))
    tops.wkv6_heads(*(torch.ones(1, 2, 1, 8) for _ in range(4)),
                    torch.ones(2, 8), torch.zeros(1, 2, 8, 8))
    assert {"mds_encode", "parity_contract", "wkv6"} <= set(
        kernels.launch_counts())
    assert set(kernels.launch_counts().values()) == {0}


# -- launch plans of the GEMM kernels (kernels/plan.py) ----------------------

#: (dtype, M, N, K, batch) at chip_smoke.py's shapes: phase c's serving
#: matmul, executor-shape and verify-shape encodes (float64 and float32),
#: phase g's executor encode (parity rows of a redundancy-1.33 plan) and
#: phase h's per-master verify encode
PLAN_SHAPES = {
    "matmul serving": ("f32", 256, 2048, 128512, 1),
    "encode executor f64": ("f64", 10000, 10000, 10000, 4),
    "encode executor f32": ("f32", 10000, 10000, 10000, 4),
    "encode verify": ("f64", 10000, 50, 10000, 1),
    "executor phase g": ("f64", 3300, 10000, 10000, 4),
    "verify phase h": ("f64", 3300, 50, 10000, 1),
    "ragged small": ("f64", 7, 65, 33, 3),
}


@pytest.mark.parametrize("label", sorted(PLAN_SHAPES))
def test_gemm_plan_fits_cuda_limits_and_its_workspace(label):
    from repro_torch.kernels.plan import gemm_plan
    dt, M, N, K, batch = PLAN_SHAPES[label]
    p = gemm_plan(dt, M, N, K, batch, sms=132)
    gx, gy, gz = p.grid
    cfg = p.config
    assert cfg.dtype == dt
    assert (gx, gy) == (-(-N // cfg.bn), -(-M // cfg.bm))
    assert gz == batch * p.splits and gy <= 65535 and gz <= 65535  # CUDA
    # slabs of a multiple of BK that cover K, none empty
    assert p.k_span % cfg.bk == 0
    assert p.splits * p.k_span >= K > (p.splits - 1) * p.k_span
    assert p.ws_elems == (p.splits * batch * M * N if p.splits > 1 else 0)


@pytest.mark.parametrize("label", ["matmul serving", "encode verify",
                                   "verify phase h"])
def test_gemm_plan_fills_the_card_at_skinny_shapes(label):
    """Too few output tiles for 132 SMs: K is split until the grid holds
    at least two blocks an SM."""
    from repro_torch.kernels.plan import gemm_plan
    p = gemm_plan(*PLAN_SHAPES[label], sms=132)
    assert p.splits > 1 and p.blocks >= 2 * 132


def test_gemm_plan_configurations():
    """float64 takes the skinny DMMA tiles up to 64 columns (computing S
    rounded up to 8), the wide ones beyond; float32 the sgemm tiles; a
    product that fills the card is not split."""
    from repro_torch.kernels.plan import gemm_plan
    assert gemm_plan("f64", 10000, 50, 10000).config.name == "dgemm_skinny"
    assert gemm_plan("f64", 10000, 50, 10000).n_tile == 56
    assert gemm_plan("f64", 100, 64, 100).config.name == "dgemm_skinny"
    assert gemm_plan("f64", 100, 65, 100).config.name == "dgemm_wide"
    assert gemm_plan("f32", 100, 5, 100).config.name == "sgemm"
    p = gemm_plan("f64", 10000, 10000, 10000, 4)
    assert p.splits == 1 and p.ws_elems == 0 and p.blocks == 79 * 79 * 4
    with pytest.raises(ValueError):
        gemm_plan("f16", 8, 8, 8)


@pytest.mark.parametrize("label,splits,blocks", [
    ("matmul serving", 12, 384), ("encode verify", 6, 474),
    ("verify phase h", 19, 494)])
def test_gemm_plan_split_rule_at_the_skinny_shapes(label, splits, blocks):
    """One split rule for every dtype, the one the kernels were measured
    with: the largest count that fits the fewest whole waves giving two
    blocks an SM (the serving matmul: 3 waves of 132, 12 blocks short of
    full; a count that fills waves best measured faster there and slower
    at the float64 verify encode)."""
    from repro_torch.kernels.plan import gemm_plan
    p = gemm_plan(*PLAN_SHAPES[label], sms=132)
    assert (p.splits, p.blocks) == (splits, blocks)


def test_build_target_follows_shared_headers(tmp_path, monkeypatch):
    """A library's hash covers csrc/*.cuh: an edited header rebuilds it."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n) for n in _build.SOURCES}
    assert before == {n: _build._target(n) for n in _build.SOURCES}
    header = csrc / "gemm_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert after["matmul"] != before["matmul"]
    assert after["mds_encode_gemm"] != before["mds_encode_gemm"]


# -- launch plans of coded_matvec (kernels/plan.py) --------------------------

#: (input bytes, R, K, C, batch) at chip_smoke.py's shapes: phase c's
#: serving tiles (one step's packed head rows against 4 slots), rwkv6-7b's
#: head, the batched executor shape (also row 2b's verify timing), phase
#: g's executor products (redundancy ~1.33), phase h's verify products
#: (verify_cols 4, ~50 tasks), and ragged ones
MATVEC_SHAPES = {
    "serving tiles": (4, 128512, 2048, 4, 1),
    "rwkv6-7b head": (4, 65536, 4096, 4, 1),
    "batched executor": (8, 20000, 10000, 1, 4),
    "executor phase g": (8, 13334, 10000, 1, 4),
    "verify phase h": (8, 10000, 4, 1, 50),
    "ragged long K": (8, 4099, 10002, 3, 1),
    "ragged short": (4, 1237, 8, 8, 4),
    "one row": (8, 1, 2, 1, 4),
    "many tasks": (8, 300, 2048, 2, 700),
}


@pytest.mark.parametrize("label", sorted(MATVEC_SHAPES))
def test_matvec_plan_fits_cuda_limits_and_covers_rows(label):
    """The grid fits CUDA's limits, and the rows per block cover R
    exactly with no block left empty."""
    from repro_torch.kernels.plan import MV_STAGE_MAX, matvec_plan
    esz, R, K, C, B = MATVEC_SHAPES[label]
    p = matvec_plan(esz, R, K, C, B, sms=132)
    gx, gy = p.grid
    assert gy == B and 1 <= gx <= 2 ** 31 - 1 and gy <= 65535
    assert p.threads <= 1024 and p.cc == min(C, 8)
    assert gx * p.rows_per_block >= R > (gx - 1) * p.rows_per_block
    if p.route == "staged":
        assert p.slab_bytes == p.cc * K * esz <= MV_STAGE_MAX
    else:
        assert p.slab_bytes == 0 and p.cc * K * esz > MV_STAGE_MAX
    # as many blocks as one wave holds, unless the rows or tasks decide
    assert p.blocks <= max(B, p.blocks_per_sm * 132)


@pytest.mark.parametrize("label,route", [("serving tiles", "staged"),
                                         ("rwkv6-7b head", "staged"),
                                         ("batched executor", "direct"),
                                         ("executor phase g", "direct"),
                                         ("verify phase h", "staged")])
def test_matvec_plan_routes(label, route):
    """X staged in shared memory when its slab is small (the serving
    tiles), read directly for a long K with few columns (the executor)."""
    from repro_torch.kernels.plan import matvec_plan
    assert matvec_plan(*MATVEC_SHAPES[label], sms=132).route == route


@pytest.mark.parametrize("label", ["batched executor", "executor phase g"])
def test_matvec_plan_executor_grid_is_whole_waves(label):
    """The executor's grid is a whole number of resident waves, at least
    two blocks an SM, and no block holds 1% more rows than the mean (no
    tail)."""
    from repro_torch.kernels.plan import matvec_plan
    p = matvec_plan(*MATVEC_SHAPES[label], sms=132)
    slots = p.blocks_per_sm * 132
    assert p.blocks % slots == 0 and p.blocks >= 2 * 132
    R = MATVEC_SHAPES[label][1]
    assert p.rows_per_block < 1.01 * R / p.grid[0]


def test_matvec_plan_rejects_what_the_kernel_cannot_take():
    from repro_torch.kernels.plan import matvec_plan
    with pytest.raises(ValueError):
        matvec_plan(8, 10, 3, 1)            # K not a multiple of 2 doubles
    with pytest.raises(ValueError):
        matvec_plan(2, 10, 8, 1)            # no half-precision kernel
    with pytest.raises(ValueError):
        matvec_plan(4, 0, 8, 1)


# -- launch plan and wrapper of wkv6 (kernels/plan.py, kernels/wkv6.py) ------

#: (T, K, V, B*H): chip_smoke.py's rwkv6-7b shapes (long prefill, serving
#: prefill, decode), the smoke model's head, and its edge shapes
WKV_PLAN_SHAPES = {
    "long prefill": (4096, 64, 64, 64),
    "serving prefill": (32, 64, 64, 256),
    "decode": (1, 64, 64, 256),
    "smoke prefill": (16, 16, 16, 8),
    "ragged": (37, 72, 20, 2),
    "decode ragged V": (1, 8, 33, 3),
    "decode V 6": (1, 64, 6, 6),
    "no steps": (0, 16, 8, 4),
    "wide V": (5, 128, 300, 2),
}


@pytest.mark.parametrize("label", sorted(WKV_PLAN_SHAPES))
def test_wkv6_plan_covers_every_row_and_column_once(label):
    """The grid's column blocks take every state column of every row
    exactly once, within CUDA's limits and the card's shared memory."""
    from repro_torch.kernels.plan import wkv6_plan
    T, K, V, BH = WKV_PLAN_SHAPES[label]
    p = wkv6_plan(T, K, V, BH, 4)
    gx, gy = p.grid
    assert gy == BH <= 65535 and p.threads <= 1024
    cols = [c for x in range(gx) for c in range(x * p.vb,
                                                min((x + 1) * p.vb, V))]
    assert cols == list(range(V))
    assert (gx - 1) * p.vb < V
    assert p.smem_bytes <= 227 * 1024 and p.blocks_per_sm >= 1
    if p.route == "decode":
        assert p.vb % p.vec == 0 and p.threads % (p.vb // p.vec) == 0
        assert p.vec == 1 or V % 4 == 0
    else:
        assert p.kk in (64, 128) and K <= p.kk and (p.kk == 64) == (K <= 64)


@pytest.mark.parametrize("T,route", [(0, "decode"), (1, "decode"),
                                     (2, "chunked"), (17, "chunked"),
                                     (32, "chunked"), (4096, "chunked")])
def test_wkv6_plan_routes(T, route):
    """T <= 1 streams the state (the decode step); longer runs take the
    chunked tensor-core route, 16 steps a chunk in sub-chunks of 4.  The
    plan takes no input type, so bf16 inputs never reach a float32-only
    route: both types run these two."""
    import inspect

    from repro_torch.kernels.plan import wkv6_plan
    assert "dtype" not in inspect.signature(wkv6_plan).parameters
    p = wkv6_plan(T, 64, 64, 256, 4)
    assert p.route == route
    assert (p.chunk, p.sub) == ((16, 4) if route == "chunked" else (1, 1))


def test_wkv6_plan_rejects_what_the_kernel_cannot_take():
    from repro_torch.kernels.plan import wkv6_plan
    for shape in ((8, 12, 8, 4), (8, 136, 8, 4), (8, 64, 8, 65536),
                  (-1, 64, 8, 4), (8, 64, 0, 4)):
        with pytest.raises(ValueError):
            wkv6_plan(*shape)


def _wkv_rows(BH=4, T=5, K=16, V=8, dt=torch.bfloat16):
    return [torch.zeros((BH, T, K), dtype=dt), torch.zeros((BH, T, K),
                                                           dtype=dt),
            torch.zeros((BH, T, V), dtype=dt), torch.ones((BH, T, K),
                                                          dtype=dt),
            torch.zeros((2, K))]


@pytest.mark.parametrize("case,match", [
    ("half", "float32 or bfloat16"),
    ("mixed types", "share one type"),
    ("u float64", "share one type"),
    ("k shape", "shapes differ"),
    ("heads", "shapes differ"),
    ("head size", "multiple of 8"),
    ("state shape", "state must be"),
    ("cpu tensors", "expected a tensor on"),
])
def test_wkv6_kernel_wrapper_raises_and_never_falls_back(case, match):
    """The kernel's wrapper refuses what the kernel cannot take, and a
    well-formed call on CPU tensors raises at the device check instead of
    taking the plain version (``wkv6_dev`` is the entry that does)."""
    from repro_torch.kernels.wkv6 import wkv6_cuda
    r, k, v, w, u = _wkv_rows()
    state = None
    if case == "half":
        r, k, v, w = (t.half() for t in (r, k, v, w))
    elif case == "mixed types":
        k = k.float()
    elif case == "u float64":
        u = u.double()
    elif case == "k shape":
        k = k[:, :4]
    elif case == "heads":
        u = torch.zeros((3, 16))
    elif case == "head size":
        r, k, v, w, u = _wkv_rows(K=12)
    elif case == "state shape":
        state = torch.zeros((4, 16, 9))
    with pytest.raises(ValueError, match=match):
        wkv6_cuda(r, k, v, w, u, state)
