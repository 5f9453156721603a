"""The port's static coded executor (``repro_torch.runtime``) against the
reference's (``repro.runtime``), on the reference's own executor case.

``"numpy"`` must be the reference's numpy path bit for bit (``run`` and
the legacy ``_run_loop``).  ``"torch"`` runs the encode, the coded
products and the decode through the kernel wrappers — here on the CPU,
where they take their plain float64 versions — and must keep the
reference's completion times and decode prefixes (all randomness stays on
the host, in the reference's draw order) with results within 1e-9
relative of the reference's float64 numpy results.
"""
import numpy as np
import pytest
import torch

from repro.core import iterated_greedy as j_greedy
from repro.core import plan_from_assignment as j_plan
from repro.core.problem import Scenario as JScenario
from repro.runtime import CodedExecutor as JExecutor
from repro_torch.core import iterated_greedy, plan_from_assignment
from repro_torch.core.problem import Scenario
from repro_torch.runtime import CodedExecutor

DEAD = [(), (1,), (2, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the driver runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _a(M=3, N=10, seed=3):
    """The reference's test scenario (``tests/test_backend.py``)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((M, N + 1))
    a[:, 0] = 0.5
    a[:, 1:] = rng.uniform(0.2, 0.4, size=(M, N))
    return a


def _exec_case(seed=0, rhs_cols=None):
    """Both packages' scenario and plan, and one set of task matrices."""
    a = _a()
    jsc = JScenario(a=a, u=1 / a, gamma=2 / a, L=np.full(a.shape[0], 96.0))
    sc = Scenario(a=a, u=1 / a, gamma=2 / a, L=np.full(a.shape[0], 96.0))
    jplan = j_plan(jsc, j_greedy(jsc, rng=0))
    plan = plan_from_assignment(sc, iterated_greedy(sc, rng=0))
    for f in ("l", "k", "b"):
        assert np.array_equal(getattr(plan, f), getattr(jplan, f))
    rng = np.random.default_rng(seed)
    A = [rng.normal(size=(96, 8)) for _ in range(sc.M)]
    cols = rhs_cols or [None] * sc.M
    x = [rng.normal(size=8 if c is None else (8, c)) for c in cols]
    return (jsc, jplan), (sc, plan), A, x


def _same_report(ours, theirs):
    assert np.array_equal(ours.completion, theirs.completion)
    for u, v in zip(ours.used_nodes, theirs.used_nodes):
        assert np.array_equal(u, v)
    assert np.array_equal(ours.redundancy, theirs.redundancy)


@pytest.mark.parametrize("dead", DEAD)
def test_numpy_backend_bit_for_bit_with_reference(dead):
    (jsc, jplan), (sc, plan), A, x = _exec_case()
    for seed in range(2):
        for method in ("run", "_run_loop"):
            res_t, rep_t = getattr(CodedExecutor(sc, plan, rng=seed,
                                                 device="cpu"), method)(
                A, x, dead_workers=dead)
            res_j, rep_j = getattr(JExecutor(jsc, jplan, rng=seed),
                                   method)(A, x, dead_workers=dead)
            _same_report(rep_t, rep_j)
            assert np.array_equal(rep_t.decode_ok, rep_j.decode_ok)
            assert np.array_equal(rep_t.max_err, rep_j.max_err)
            for u, v in zip(res_t, res_j):
                assert np.array_equal(np.nan_to_num(u, nan=-1.0),
                                      np.nan_to_num(v, nan=-1.0))


@pytest.mark.parametrize("dead", DEAD)
def test_torch_backend_matches_reference_numpy(dead):
    (jsc, jplan), (sc, plan), A, x = _exec_case()
    for seed in range(2):
        res_t, rep_t = CodedExecutor(sc, plan, rng=seed, backend="torch",
                                     device="cpu").run(A, x,
                                                       dead_workers=dead)
        res_j, rep_j = JExecutor(jsc, jplan, rng=seed).run(
            A, x, dead_workers=dead)
        _same_report(rep_t, rep_j)
        assert rep_t.decode_ok.all(), rep_t.max_err
        for u, v in zip(res_t, res_j):
            np.testing.assert_allclose(u, v, rtol=1e-9,
                                       atol=1e-9 * np.abs(v).max())


def test_torch_backend_matrix_rhs_and_mixed_shapes():
    """Matrix right-hand sides (x (S, C)) and mixed RHS shapes in one run:
    one stacked group per shape, the (B, L, C) gather of received rows."""
    (jsc, jplan), (sc, plan), A, x = _exec_case(seed=9, rhs_cols=[None, 3, 2])
    res_t, rep_t = CodedExecutor(sc, plan, rng=0, backend="torch",
                                 device="cpu").run(A, x, dead_workers=(1,))
    res_j, rep_j = JExecutor(jsc, jplan, rng=0).run(A, x, dead_workers=(1,))
    _same_report(rep_t, rep_j)
    assert rep_t.decode_ok.all()
    for u, v in zip(res_t, res_j):
        assert u.shape == v.shape
        np.testing.assert_allclose(u, v, rtol=1e-9,
                                   atol=1e-9 * np.abs(v).max())


def test_torch_verify_tol_is_float64():
    _, (sc, plan), _, _ = _exec_case()
    for be in ("numpy", "torch"):
        assert CodedExecutor(sc, plan, backend=be,
                             device="cpu").verify_tol == 1e-6
    with pytest.raises(ValueError, match="backend"):
        CodedExecutor(sc, plan, backend="pallas", device="cpu")
