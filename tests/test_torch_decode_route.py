"""The on-card decode's two routes for a parity minor (the port's
``serve_coded/packing.py``): an in-place float64 LU while 8 s² bytes fit,
else a float32 LU refined in float64 against the minor's float64 product
from the counters.  Here on the CPU through the kernels' plain versions,
the minor budget lowered (``MINOR_BUDGET``) to send small minors down the
refined route; held against the float64 route on the same plan and the
reference's host decode on the same parameters."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.serve_coded import CodedLinear as JLinear  # noqa: E402
from repro.stream import backend as jbk  # noqa: E402
from repro_torch.obs import Tracer, use_tracer  # noqa: E402
from repro_torch.serve_coded import CodedLinear  # noqa: E402
from repro_torch.serve_coded import packing  # noqa: E402
from repro_torch.stream import backend as bk  # noqa: E402

L, D, C = 640, 16, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(s: int, seed: int):
    """A port and a reference layer of the same weights and parity key,
    and a delivered row set of L rows with ``s`` parity rows."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(L, D))
    kw = dict(name="head", seed=3, parity_chunk=64,
              parity_storage="virtual")
    tl = CodedLinear(W, backend="torch", device="cpu", **kw)
    jl = JLinear(W, **kw)
    tl.ensure_parity(s + 16)
    jl.ensure_parity(s + 16)
    rows = rng.permutation(np.concatenate(
        [rng.permutation(L)[:L - s], L + rng.permutation(s + 16)[:s]]))
    X = rng.normal(size=(C, D))
    G = bk.SystematicRows(L, L + s + 16, tl.parity_rows)
    y = G.take(rows) @ (W @ X.T)                      # (L, C) products
    return tl, jl, rows, y, W @ X.T


def _decode(tl, rows, y, budget, monkeypatch):
    monkeypatch.setattr(packing, "MINOR_BUDGET", budget)
    tr = Tracer(meta={"test": "decode_route"})
    with use_tracer(tr):
        z = packing.DeviceRowsDecode(tl, rows).apply(y[None])[0]
    routes = {sp.args["route"] for sp in tr.spans
              if sp.name == "decode:factor"}
    return z, routes


@pytest.mark.parametrize("s", [200, 320])
def test_refined_route_matches_float64_route_and_reference(s, monkeypatch):
    tl, jl, rows, y, truth = _plan(s, seed=s)
    z64, r64 = _decode(tl, rows, y, None, monkeypatch)
    sweeps0 = len(packing.SWEEPS)
    zr, rr = _decode(tl, rows, y, 8 * s * s - 1, monkeypatch)
    assert r64 == {"float64"} and rr == {"refined"}
    assert len(packing.SWEEPS) == sweeps0 + 1
    assert 1 <= packing.SWEEPS[-1] <= packing.REFINE_SWEEPS
    # the reference bridge's host decode (scipy float64 LU) of the same
    # rows over the same counter-derived generator
    G = jbk.SystematicRows(L, L + s + 16, jl.parity_rows)
    zh = jbk.plan_decode(G, rows[None]).apply(y[None])[0]
    scale = np.abs(truth).max()
    assert np.abs(zr - z64).max() <= 1e-10 * scale
    assert np.abs(zr - zh).max() <= 1e-10 * scale
    assert np.abs(zr - truth).max() <= 1e-10 * scale


def test_refined_route_in_the_serving_decode_group(monkeypatch):
    """The batched engine's stacked decode (``_DeviceDecodeGroup``, the
    same member solve) on the refined route against the numpy engine."""
    monkeypatch.setattr(packing, "DECODE_CHUNK", 4096)
    tl, _, rows, y, truth = _plan(256, seed=5)
    prob = packing.ShardProblem(key="head", linear=tl, rows=rows,
                                used_solve=True)
    stg = packing.PackedStage([prob], backend="torch")
    (grp,) = stg.groups[0][3]
    member = grp.members[0]
    monkeypatch.setattr(packing, "MINOR_BUDGET", 0)
    with pytest.raises(MemoryError, match="s = 256 rows needs 524288 bytes"):
        grp.apply(torch.from_numpy(y[None]), torch.empty((1, L, C),
                                                         dtype=torch.float64))
    monkeypatch.setattr(packing, "MINOR_BUDGET", 4 * 256 * 256)
    z = torch.empty((1, L, C), dtype=torch.float64)
    grp.apply(torch.from_numpy(y[None]), z)
    assert member.route == "refined" and member.lu[0].dtype == torch.float32
    assert np.abs(z[0].numpy() - truth).max() <= 1e-10 * np.abs(truth).max()


@pytest.mark.parametrize("n", [300, 4000])
def test_route_is_chosen_by_size(n, monkeypatch):
    dev = torch.device("cpu")
    monkeypatch.setattr(packing, "MINOR_BUDGET", 8 * n * n)
    assert packing.minor_route(n, dev) == "float64"
    monkeypatch.setattr(packing, "MINOR_BUDGET", 8 * n * n - 1)
    assert packing.minor_route(n, dev) == "refined"
    monkeypatch.setattr(packing, "MINOR_BUDGET", 4 * n * n)
    assert packing.minor_route(n, dev) == "refined"
    monkeypatch.setattr(packing, "MINOR_BUDGET", 4 * n * n - 1)
    with pytest.raises(MemoryError, match=f"s = {n} rows needs {8 * n * n} "
                       f"bytes in float64 or {4 * n * n} in float32"):
        packing.minor_route(n, dev)


@pytest.mark.parametrize("kind", ["ill_conditioned", "singular"])
def test_ill_conditioned_minor_raises(kind):
    """Float32 factors of a minor whose condition number is past 1/u32
    cannot be refined to float64: the solve raises instead of returning."""
    rng = np.random.default_rng(7)
    n = 256
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = np.logspace(0, -12, n)
    if kind == "singular":
        sv[-4:] = 0.0
    A = torch.from_numpy((U * sv) @ V.T)
    fac = bk.lu_factor_torch(A.float().mT.contiguous().mT)
    b = torch.from_numpy(rng.normal(size=(n, 2)))
    with pytest.raises(np.linalg.LinAlgError):
        packing.refine_solve(fac, b, lambda z: A @ z,
                             float(A.abs().sum(1).max()))


def test_refine_solve_converges_on_a_well_conditioned_matrix():
    rng = np.random.default_rng(8)
    n = 300
    A = torch.from_numpy(rng.normal(size=(n, n)))
    z_true = torch.from_numpy(rng.normal(size=(n, 2)))
    b = A @ z_true
    fac = bk.lu_factor_torch(A.float().mT.contiguous().mT)
    z, sweeps = packing.refine_solve(fac, b, lambda z: A @ z,
                                     float(A.abs().sum(1).max()))
    assert 1 <= sweeps <= 6
    z64 = torch.linalg.solve(A, b)
    assert float((z - z64).abs().max()) <= 1e-11 * float(z64.abs().max())


def test_factors_of_other_plans_are_released_least_recently_used_first(
        monkeypatch):
    """When a minor needs the room, the cached factors of other members go
    first, least recently used first, and a released member refactors from
    its counters on its next solve (the same result)."""
    import collections
    # this test's members only (earlier tests' may still be alive)
    monkeypatch.setattr(packing, "_FACTORED", collections.OrderedDict())
    members = []
    for s_, seed in ((200, 21), (220, 22), (240, 23)):
        tl, _, rows, y, _ = _plan(s_, seed)
        m = packing._DeviceMember(tl, rows)
        z = torch.empty((L, C), dtype=torch.float64)
        m.solve(torch.from_numpy(y), z)
        members.append((m, torch.from_numpy(y), z))
    (a, ya, _), (b, yb, zb), (c, _, _) = members
    a.solve(ya, torch.empty((L, C), dtype=torch.float64))
    cpu = torch.device("cpu")
    assert packing._factored(cpu) == [b, c, a]          # b least recent
    assert packing._factored(cpu, keep=c) == [b, a]
    size = {id(m): packing._nbytes(m) for m in (a, b, c)}
    # as on the card: each release frees its factors' bytes
    monkeypatch.setattr(packing, "_free", lambda dev: sum(
        size[id(m)] for m in (a, b, c) if m.lu is None))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    packing._make_room(size[id(b)], cpu, keep=c)
    assert b.lu is None and a.lu is not None and c.lu is not None
    packing._make_room(size[id(b)] + 1, cpu, keep=c)
    assert a.lu is None and c.lu is not None
    monkeypatch.undo()
    z = torch.empty((L, C), dtype=torch.float64)
    b.solve(yb, z)
    assert b.lu is not None and torch.equal(z, zb)
