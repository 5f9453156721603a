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


def test_launch_counts_stay_zero_on_cpu():
    """The plain versions are not kernel launches."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    tops.matmul(torch.ones(4, 4), torch.ones(4, 4))
    tops.counter_parity_rows((1, 2), 8, np.arange(3), device="cpu")
    assert set(kernels.launch_counts().values()) == {0}
