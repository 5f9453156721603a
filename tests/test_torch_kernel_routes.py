"""The launch routes of the port's skinny products: ``coded_matvec``'s wide
route (more than 8 columns summed in float64, on the FP64 tensor cores)
and its direct route's X (read in place, or from a [cc][K] copy),
``mds_encode``'s float32 stream route (a few computed rows against a few
rows of A) and the wide parity contraction (more than 8 float64 columns,
one launch per 64), their plans in ``repro_torch.kernels.plan``, and the
wrappers that launch them.

On this CPU the wrappers run their plain versions, held here against the
reference's Pallas kernels in interpret mode at the new routes' shapes;
the CUDA kernels are held against the same plain versions, and against
the routes they replace, on the card by ``chip_smoke.py``.  The plans are
plain Python and are checked at the path's shapes and, with hypothesis,
over the shapes a caller may give.
"""
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import coded_matvec as tcmv  # noqa: E402
from repro_torch.kernels import mds_encode as tenc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import plan  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- coded_matvec's plans ----------------------------------------------------

@pytest.mark.parametrize("esz,out_esz,C,routes", [
    (4, 8, 9, ["wide"]), (4, 8, 32, ["wide"]), (4, 8, 64, ["wide"]),
    (4, 8, 65, ["wide", "wide"]), (8, 8, 12, ["wide"]),
    (4, 8, 8, ["staged"]), (4, 8, 4, ["staged"]), (8, 8, 1, ["staged"]),
    (4, 4, 9, ["staged", "staged"]), (4, 4, 32, ["staged"] * 4),
])
def test_matvec_plan_takes_the_wide_route_exactly_past_8_float64_columns(
        esz, out_esz, C, routes):
    """More than 8 columns summed in float64 take the wide route, 64
    columns a launch; float32 sums keep the 8-column launches at any C, and
    so does every product of at most 8 columns."""
    launches = plan.matvec_launches(esz, 1000, 256, C, 1, 132, out_esz)
    assert [p.route for _, p in launches] == routes
    width = 64 if routes[0] == "wide" else 8
    assert [c0 for c0, _ in launches] == list(range(0, C, width))


#: row 2t's packed trunk stages at the prefill's C = 32 (rows, K): one
#: wide launch each, K cut in 8 slabs of 256 (K 2048) or 1024 (K 8192)
TRUNK = {"q/k/v": (3072, 2048), "o": (2048, 2048), "up/gate": (16384, 2048),
         "down": (2048, 8192)}


@pytest.mark.parametrize("stage", sorted(TRUNK))
def test_matvec_plan_at_the_trunk_prefill(stage):
    R, K = TRUNK[stage]
    (c0, p), = plan.matvec_launches(4, R, K, 32, 1, 132, 8)
    assert (p.route, p.cc, p.splits) == ("wide", 32, 8)
    assert p.k_span == K // 8 and p.grid == (R // 128, 1)
    assert p.blocks == R // 128 * 8


@settings(max_examples=200, deadline=None)
@given(esz=st.sampled_from([4, 8]), R=st.integers(1, 300_000),
       kq=st.integers(0, 6000), C=st.integers(9, 300),
       batch=st.integers(1, 65535), sms=st.integers(1, 264))
def test_wide_plan_slabs_follow_k_alone_and_cover_the_product(
        esz, R, kq, C, batch, sms):
    """The wide route's K slabs are a function of K and the element size
    alone -- the same at any R, task count or card, so a row's sum has one
    order however the rows are bucketed -- and the launches take every row,
    every column and every K element once, no slab empty, within CUDA's
    grid limits and a portable cluster of at most 8 blocks."""
    K = kq * (16 // esz)
    launches = plan.matvec_launches(esz, R, K, C, batch, sms, 8)
    ref = plan.matvec_launches(esz, 1, K, C, 1, 1, 8)
    assert [(c0, p.cc, p.splits, p.k_span) for c0, p in launches] == \
        [(c0, p.cc, p.splits, p.k_span) for c0, p in ref]
    cols = [c for c0, p in launches for c in range(c0, c0 + p.cc)]
    assert cols == list(range(C))
    for _, p in launches:
        assert p.route == "wide" and 1 <= p.cc <= plan.MV_WIDE_COLS
        gx, gb = p.grid
        assert gb == batch and gx * p.rows_per_block >= R \
            > (gx - 1) * p.rows_per_block
        assert gx <= 2 ** 31 - 1 and batch <= 65535
        assert 1 <= p.splits <= plan.MV_WIDE_MAX_SPLITS
        assert p.k_span % (plan.MV_WIDE_ROW_BYTES // esz) == 0
        assert p.splits * p.k_span >= K > (p.splits - 1) * p.k_span \
            or (K == 0 and p.splits == 1)


@pytest.mark.parametrize("args,kw", [
    ((8, 10, 8, 12), dict(out_esz=4)),      # float64 in, float32 sums
    ((2, 10, 8, 12), dict(out_esz=8)),      # no half-precision kernel
    ((4, 10, 6, 12), dict(out_esz=8)),      # K not a multiple of 4 floats
    ((8, 10, 3, 12), dict(out_esz=8)),      # K not a multiple of 2 doubles
    ((4, 10, 8, 12, 65536), dict(out_esz=8)),   # grid z past 65535
    ((4, 10, 8, 12), dict(out_esz=8, c0=12)),   # no column left
    ((4, 0, 8, 12), dict(out_esz=8)),
])
def test_matvec_plan_refuses_what_the_wide_kernel_cannot_take(args, kw):
    with pytest.raises(ValueError):
        plan.matvec_plan(*args, **kw)


#: (input bytes, R, K, C, c0) -> whether the direct route copies X: in
#: place at C = 1 and where a row of the chunk is at most 4 columns of
#: whole 16-byte vectors (rows 2d and 2t ``down`` at C = 4 float32, C = 2
#: and 4 float64), else from a [cc][K] copy (the ragged long K, a float32
#: C = 3 or 8, a chunk at an odd offset)
DIRECT_X = {
    "2d head": ((4, 129536, 7168, 4, 0), False),
    "2t down C=4": ((4, 2048, 8192, 4, 0), False),
    "f64 C=2": ((8, 20000, 10000, 2, 0), False),
    "f64 C=4": ((8, 20000, 10000, 4, 0), False),
    "executor C=1": ((8, 20000, 10000, 1, 0), False),
    "ragged long K": ((8, 4099, 10002, 3, 0), True),
    "f32 C=3": ((4, 4099, 8192, 3, 0), True),
    "f32 C=8": ((4, 4099, 8192, 8, 0), True),
    "f64 C=8": ((8, 4099, 10002, 8, 0), True),
    "f32 chunk of C=12": ((4, 4099, 8192, 12, 8), False),
    "f32 chunk of C=11": ((4, 4099, 8192, 11, 8), True),
    "f64 C=5": ((8, 4099, 10002, 5, 0), True),
}


@pytest.mark.parametrize("label", sorted(DIRECT_X))
def test_direct_route_reads_x_in_place_or_from_a_copy(label):
    (esz, R, K, C, c0), copy = DIRECT_X[label]
    p = plan.matvec_plan(esz, R, K, C, 1, 132, 4 if C > 8 else 8, c0)
    assert p.route == "direct" and p.x_copy == copy and p.slab_bytes == 0


# -- the parity contraction's plans ------------------------------------------

@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 300_000), m=st.integers(0, 200_000),
       C=st.integers(9, 300))
def test_wide_contract_slabs_follow_m_alone_and_cover_the_product(n, m, C):
    """The wide contraction's column slabs are a function of m alone -- the
    same at any n or C, so a column's sum has one order wherever it sits --
    and its launches take every row, column of Z and column of R once, one
    launch per 64 columns, no slab empty, within CUDA's grid limits and a
    portable cluster of at most 8 blocks."""
    launches = plan.contract_launches(n, m, C)
    alone = plan.contract_launches(1, m, 1, "wide")
    assert len(launches) == -(-C // plan.CT_WIDE_COLS)
    cols = [c for c0, p in launches for c in range(c0, c0 + p.cc)]
    assert cols == list(range(C))
    for _, p in launches:
        assert p.route == "wide" and (p.splits, p.m_span) == \
            (alone[0][1].splits, alone[0][1].m_span)
        gx, gy = p.grid
        assert gy == p.splits and gx * plan.CT_WIDE_ROWS >= n \
            > (gx - 1) * plan.CT_WIDE_ROWS and gx <= 2 ** 31 - 1
        assert 1 <= p.splits <= plan.CT_WIDE_MAX_SPLITS
        assert p.m_span % plan.CT_WIDE_BK == 0
        assert p.splits * p.m_span >= m > (p.splits - 1) * p.m_span \
            or (m == 0 and p.splits == 1)


@pytest.mark.parametrize("C,routes", [
    (1, ["narrow"]), (4, ["narrow"]), (8, ["narrow"]), (9, ["wide"]),
    (32, ["wide"]), (64, ["wide"]), (65, ["wide", "wide"]),
    (100, ["wide", "wide"]),
])
def test_contract_plan_takes_the_wide_route_exactly_past_8_columns(C,
                                                                  routes):
    """At most 8 columns keep one launch of the narrow kernel (rows 3, 3b,
    3bd, 3c, 4); past 8, one wide launch per 64 columns (row 3t at C = 32:
    635 rows in 20 blocks of 32 x 8 slabs of 192 known columns)."""
    launches = plan.contract_launches(635, 1413, C)
    assert [p.route for _, p in launches] == routes
    if routes == ["narrow"]:
        (_, p), = launches
        assert p.cc == C and p.grid == (-(-635 // plan.CT_ROWS), 1)
    if C == 32:
        (_, p), = launches
        assert (p.grid, p.splits, p.m_span) == ((20, 8), 8, 192)
    narrow = plan.contract_launches(635, 1413, C, "narrow")
    assert [c0 for c0, _ in narrow] == list(range(0, C, 8))
    assert {p.route for _, p in narrow} == {"narrow"}


def test_contract_plan_refuses_what_the_kernels_cannot_take():
    for args in ((0, 10, 4), (10, -1, 4), (10, 10, 0), (10, 10, 4, 4)):
        with pytest.raises(ValueError):
            plan.contract_plan(*args)
    with pytest.raises(ValueError, match="unknown route"):
        plan.contract_plan(10, 10, 4, 0, "element")


# -- mds_encode's plans ------------------------------------------------------

#: (dtype, computed rows, columns, K, tasks) of PERF.md's encode rows
ENCODE_ROWS = {
    "5g coded gradients": ("f32", 2, 1_236_338_688, 4, 1),
    "5 executor f64": ("f64", 10_000, 10_000, 10_000, 4),
    "5b verify": ("f64", 10_000, 50, 10_000, 1),
    "5f executor f32": ("f32", 10_000, 10_000, 10_000, 4),
    "1 matmul shape": ("f32", 256, 2048, 128_512, 1),
    "f64 at 5g's shape": ("f64", 2, 1_236_338_688, 4, 1),
    "9 computed rows": ("f32", 9, 4096, 4, 1),
    "9 rows of A": ("f32", 2, 4096, 9, 1),
}


@pytest.mark.parametrize("label", sorted(ENCODE_ROWS))
def test_encode_plan_streams_only_the_skinny_float32_encode(label):
    p = plan.encode_plan(*ENCODE_ROWS[label], sms=132)
    want = "stream" if label.startswith("5g") else "gemm"
    assert p.route == want
    if want == "stream":
        gx, gb = p.grid
        assert (p.rows, p.k) == (2, 4) and gb == 1
        assert gx == plan.ENC_STREAM_BLOCKS_PER_SM * 132
    else:
        assert p == plan.gemm_plan(*ENCODE_ROWS[label], sms=132)


# -- the plain versions against the reference's kernels ------------------------

@pytest.mark.parametrize("C", [12, 32])
def test_coded_matvec_many_columns_matches_reference(C):
    """``ops.coded_matvec`` (float32, the reference's numerics) and
    ``coded_shard_matmul_batch`` (float64 sums, the wide route on the
    card) against the reference's interpret-mode kernel at 1e-4, its own
    tolerance; the float64 sums also against numpy at 1e-12."""
    rng = np.random.default_rng(100 + C)
    a = rng.normal(size=(300, 200)).astype(np.float32)
    x = rng.normal(size=(200, C)).astype(np.float32)
    ours = tops.coded_matvec(_t(a), _t(x)).numpy()
    theirs = np.asarray(jops.coded_matvec(jnp.asarray(a), jnp.asarray(x),
                                          interpret=True))
    assert ours.shape == theirs.shape == (300, C)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-4)
    tiles = rng.normal(size=(3, 128, 256)).astype(np.float32)
    xt = rng.normal(size=(256, C)).astype(np.float32)
    ours = tops.coded_shard_matmul_batch(_t(tiles), _t(xt))
    assert ours.dtype == torch.float64 and ours.shape == (3, 128, C)
    theirs = np.asarray(jops.coded_shard_matmul_batch(
        jnp.asarray(tiles), jnp.asarray(xt), mode="pallas", interpret=True))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
    exact = np.einsum("trk,kc->trc", tiles.astype(np.float64),
                      xt.astype(np.float64))
    np.testing.assert_allclose(ours.numpy(), exact, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("S,per_task", [(1029, False), (4099, True)])
def test_mds_encode_skinny_ragged_matches_reference(S, per_task):
    """The coded-gradient encode's shape, (6 x 4) @ (4 x S) float32 with a
    ragged S (the stream route on the card): against the reference's
    interpret-mode kernel at its 2e-3, the systematic rows A bit for bit;
    per-task generators over 3 tasks through ``mds_encode_batch``."""
    rng = np.random.default_rng(S)
    B = 3 if per_task else 1
    G = rng.normal(0, 0.5, size=(B, 6, 4) if per_task else (6, 4))
    G[..., :4, :] = np.eye(4)
    A = rng.normal(size=(B, 4, S))
    G32, A32 = G.astype(np.float32), A.astype(np.float32)
    if per_task:
        ours = tops.mds_encode_batch(_t(G32), _t(A32)).numpy()
        theirs = np.asarray(jops.mds_encode_batch(
            jnp.asarray(G32), jnp.asarray(A32), interpret=True))
    else:
        ours = tops.mds_encode(_t(G32), _t(A32[0])).numpy()[None]
        theirs = np.asarray(jops.mds_encode(jnp.asarray(G32),
                                            jnp.asarray(A32[0]),
                                            interpret=True))[None]
    assert ours.shape == theirs.shape == (B, 6, S)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(ours[:, :4], A32)
    assert plan.encode_plan("f32", 2, S, 4, B).route == "stream"


# -- no fallback: a failed build or launch raises -------------------------------

def _on_the_card(monkeypatch, module, lib):
    """Let ``module``'s CUDA wrapper take CPU tensors up to its launch:
    the device checks pass, the stream and SM count are stand-ins, and the
    library is ``lib`` (or raises as a failed build does)."""
    monkeypatch.setattr(module, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(module, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(module, "sm_count", lambda dev: 132)

    def library(name):
        if lib is None:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit 1)")
        return lib
    monkeypatch.setattr(module._build, "library", library)


def _failing_lib(code: int, *names):
    return types.SimpleNamespace(**{n: (lambda *a: code) for n in names})


@pytest.mark.parametrize("C,build_fails", [(32, False), (4, False),
                                           (32, True)])
def test_coded_matvec_kernel_raises_and_never_falls_back(monkeypatch, C,
                                                         build_fails):
    """On the card's path the wrapper launches the kernel of its route or
    raises: a launch error (the wide route at C = 32, the narrow one at C
    = 4) and a failed build reach the caller, and no plain version
    answers."""
    _on_the_card(monkeypatch, tcmv, None if build_fails else _failing_lib(
        98, "repro_coded_matvec", "repro_coded_matvec_wide"))
    a, x = torch.ones(256, 64), torch.ones(64, C)
    n0 = tcmv.LAUNCHES
    with pytest.raises(RuntimeError,
                       match="nvcc failed" if build_fails
                       else "cudaError_t 98"):
        tcmv.coded_matvec_cuda(a, x, out_dtype=torch.float64)
    assert tcmv.LAUNCHES == n0


@pytest.mark.parametrize("route,build_fails", [("stream", False),
                                               ("gemm", False),
                                               ("stream", True)])
def test_mds_encode_kernel_raises_and_never_falls_back(monkeypatch, route,
                                                       build_fails):
    _on_the_card(monkeypatch, tenc, None if build_fails else _failing_lib(
        98, "repro_mds_encode", "repro_mds_encode_stream"))
    g, a = torch.ones(6, 4), torch.ones(1, 4, 1029)
    n0 = tenc.ENCODE_LAUNCHES
    with pytest.raises(RuntimeError,
                       match="nvcc failed" if build_fails
                       else "cudaError_t 98"):
        tenc.mds_encode_cuda(g, a, route=route)
    assert tenc.ENCODE_LAUNCHES == n0


class _Recorder:
    """A stand-in library that records each call of its entry points and
    returns 0 (a launch that succeeded)."""

    def __init__(self, *names):
        self.calls = []
        for name in names:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("C,out,route,code,copy", [
    (4, torch.float64, None, 1, False),         # rows 2d, 2t down: in place
    (3, torch.float64, None, 1, True),          # a [cc][K] copy first
    (4, torch.float64, "element", 2, False),    # the parent's route
    (3, torch.float32, "element", 2, False),
    (1, torch.float64, None, 1, False),         # XV
])
def test_coded_matvec_direct_route_hands_its_x_copy_to_the_launch(
        monkeypatch, C, out, route, code, copy):
    """On the direct route the wrapper passes the route code and, where the
    plan copies X, a scratch of cc x K elements of the input type."""
    lib = _Recorder("repro_coded_matvec", "repro_coded_matvec_wide")
    _on_the_card(monkeypatch, tcmv, lib)
    a, x = torch.ones(512, 20480), torch.ones(20480, C)
    tcmv.coded_matvec_cuda(a, x, out_dtype=out, route=route)
    (name, args), = lib.calls
    assert name == "repro_coded_matvec" and args[9] == code
    assert (args[-2] is not None) == copy


@pytest.mark.parametrize("C,gathered,names", [
    (4, True, ["repro_parity_contract"]),
    (32, True, ["repro_parity_contract_wide"]),
    (100, False, ["repro_parity_contract_wide"] * 2),
    (12, False, ["repro_parity_contract"] * 2),     # float32 z: narrow
])
def test_parity_contract_launches_on_its_plan(monkeypatch, C, gathered,
                                              names):
    """One narrow launch for up to 8 columns, one wide launch per 64
    columns of a float64 z (the column offset and the plan's grid and slabs
    handed over, z and the output whole), 8-column launches for a float32
    z; the launches counted by route."""
    lib = _Recorder("repro_parity_contract", "repro_parity_contract_wide",
                    "repro_counter_parity_rows")
    _on_the_card(monkeypatch, tenc, lib)
    dt = torch.float32 if names[0] == "repro_parity_contract" and C > 8 \
        else torch.float64
    z = torch.ones(300, C, dtype=dt)
    c32 = torch.arange(40, dtype=torch.int32)
    j32 = torch.arange(300, dtype=torch.int32) if gathered else None
    n0 = (tenc.CONTRACT_LAUNCHES, tenc.WIDE_CONTRACT_LAUNCHES)
    out, narrow = tenc._contract((1, 2), 0.5, c32, j32, z, "parity_contract")
    assert [name for name, _ in lib.calls] == names
    assert out.shape == (40, C) and out.dtype == dt
    wide = [args for name, args in lib.calls
            if name == "repro_parity_contract_wide"]
    launches = plan.contract_launches(40, 300, C)
    for (c0, p), args in zip(launches, wide):
        assert args[8:10] == (C, c0) and args[11:14] == (p.grid[0], p.splits,
                                                          p.m_span)
        assert args[7] == z.data_ptr() and args[10] == out.data_ptr()
    assert narrow == len(names) - len(wide)
    assert tenc.WIDE_CONTRACT_LAUNCHES - n0[1] == len(wide)


@pytest.mark.parametrize("C,copy,build_fails", [(4, False, False),
                                                (3, True, False),
                                                (4, False, True)])
def test_coded_matvec_direct_route_raises_and_never_falls_back(
        monkeypatch, C, copy, build_fails):
    """The direct route at 2 <= C <= 8 (X read in place, or from its copy)
    launches its kernel or raises: a launch error and a failed build reach
    the caller, and no plain version answers."""
    _on_the_card(monkeypatch, tcmv, None if build_fails else _failing_lib(
        98, "repro_coded_matvec", "repro_coded_matvec_wide"))
    a, x = torch.ones(512, 8192), torch.ones(8192, C)
    assert plan.matvec_plan(4, 512, 8192, C, 1, 132, 8).x_copy == copy
    n0 = tcmv.LAUNCHES
    with pytest.raises(RuntimeError,
                       match="nvcc failed" if build_fails
                       else "cudaError_t 98"):
        tcmv.coded_matvec_cuda(a, x, out_dtype=torch.float64)
    assert tcmv.LAUNCHES == n0


@pytest.mark.parametrize("C,gathered,build_fails", [(32, True, False),
                                                    (100, False, False),
                                                    (32, False, True)])
def test_parity_contract_wide_raises_and_never_falls_back(
        monkeypatch, C, gathered, build_fails):
    """The wide contraction launches its kernel or raises, gathered (the
    decode's known term) and not (the generated-parity lanes): a launch
    error and a failed build reach the caller, nothing is counted, and no
    plain version answers."""
    _on_the_card(monkeypatch, tenc, None if build_fails else _failing_lib(
        98, "repro_parity_contract", "repro_parity_contract_wide",
        "repro_counter_parity_rows"))
    z = torch.ones(300, C, dtype=torch.float64)
    c32 = torch.arange(40, dtype=torch.int32)
    j32 = torch.arange(300, dtype=torch.int32) if gathered else None
    n0 = (tenc.CONTRACT_LAUNCHES, tenc.WIDE_CONTRACT_LAUNCHES,
          tenc.GEN_LAUNCHES)
    with pytest.raises(RuntimeError,
                       match="nvcc failed" if build_fails
                       else "cudaError_t 98"):
        tenc._contract((1, 2), 0.5, c32, j32, z, "parity_contract")
    assert (tenc.CONTRACT_LAUNCHES, tenc.WIDE_CONTRACT_LAUNCHES,
            tenc.GEN_LAUNCHES) == n0


def test_routes_refuse_what_they_cannot_take(monkeypatch):
    """The stream route takes only the skinny float32 encode, and the
    matvec wrapper knows no other route than its plan's or the narrow
    one."""
    _on_the_card(monkeypatch, tenc, _failing_lib(
        0, "repro_mds_encode", "repro_mds_encode_stream"))
    with pytest.raises(ValueError, match="route 'stream' cannot take"):
        tenc.mds_encode_cuda(torch.ones(20, 10), torch.ones(1, 10, 64),
                             route="stream")
    with pytest.raises(ValueError, match="route 'stream' cannot take"):
        tenc.mds_encode_cuda(torch.ones(6, 4, dtype=torch.float64),
                             torch.ones(1, 4, 64, dtype=torch.float64),
                             route="stream")
    with pytest.raises(ValueError, match="unknown route"):
        tcmv.coded_matvec_cuda(torch.ones(16, 8), torch.ones(8, 12),
                               out_dtype=torch.float64, route="wide")
    # the wide contraction takes a float64 z only, and knows no other route
    _on_the_card(monkeypatch, tenc, _failing_lib(
        0, "repro_parity_contract", "repro_parity_contract_wide",
        "repro_counter_parity_rows"))
    with pytest.raises(ValueError, match="takes a float64 z"):
        tenc._contract((1, 2), 0.5, torch.arange(4, dtype=torch.int32), None,
                       torch.ones(30, 12), "gen_parity_matvec", "wide")
    with pytest.raises(ValueError, match="unknown route"):
        tenc.parity_contract_dev((1, 2), 0.5, torch.arange(4), None,
                                 torch.ones(30, 12, dtype=torch.float64),
                                 route="element")
