"""The port's Monte-Carlo simulator against the reference and the closed
form.

``backend="numpy"`` is the reference's Generator stream and must equal it
bit for bit; ``backend="torch"`` (here on ``device="cpu"``) draws from a
``torch.Generator`` and is held to numpy statistically: the means within
4 combined standard errors, and the single-node empirical CDF at its
median within 0.06 of the closed form, as the reference's own test.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import (Plan, Scenario, iterated_greedy,
                              large_scale_scenario, plan_from_assignment,
                              simple_greedy, small_scale_scenario)
from repro_torch.core.delays import cdf_total
from repro_torch.sim import simulate_plan
from repro_torch.sim.montecarlo import _completion_times
from repro_torch.stream.backend import simulate_batch

jsim = pytest.importorskip("repro.sim")
import repro.core as jcore  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: several test processes run at once,
    and the thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
        limits = threadpool_limits(1)
    except ImportError:                  # no BLAS control: leave it
        limits = contextlib.nullcontext()
    with limits:
        yield
    torch.set_num_threads(n)


def _plan(sc, seed):
    return plan_from_assignment(sc, iterated_greedy(sc, rng=seed))


def _uncoded(sc):
    plan = plan_from_assignment(sc, simple_greedy(sc))
    return Plan(k=plan.k, b=plan.b, l=plan.l, t_per_master=plan.t_per_master,
                method="uncoded")


def _sem(x) -> float:
    return float(np.std(x) / np.sqrt(len(x)))


# ---------------------------------------------------------------------------
# The reference's cases, on the port
# ---------------------------------------------------------------------------

def test_completion_times_manual_case():
    T = np.array([[5.0, 1.0, 3.0], [2.0, 9.0, 4.0]])
    loads = np.array([4.0, 4.0, 4.0])
    np.testing.assert_allclose(_completion_times(T, loads, need=8.0),
                               [3.0, 4.0])
    assert np.isinf(_completion_times(T, loads, need=20.0)).all()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_markov_bound_holds_empirically(backend):
    """P[node finishes by t*] ≥ 1/2 at the Thm-1 point."""
    sc = small_scale_scenario(0)
    plan = _plan(sc, 0)
    r = simulate_plan(sc, plan, trials=20_000, rng=5, keep_samples=True,
                      backend=backend, device="cpu")
    assert np.mean(r.overall_samples <= plan.t) > 0.5


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_simulator_seed_reproducible(backend):
    sc = small_scale_scenario(1)
    plan = _plan(sc, 1)
    r1 = simulate_plan(sc, plan, trials=2000, rng=9, keep_samples=True,
                       backend=backend, device="cpu")
    r2 = simulate_plan(sc, plan, trials=2000, rng=9, keep_samples=True,
                       backend=backend, device="cpu")
    assert r1.overall_mean == r2.overall_mean
    assert np.array_equal(r1.per_master_samples, r2.per_master_samples)
    r3 = simulate_plan(sc, plan, trials=2000, rng=10, backend=backend,
                       device="cpu")
    assert r3.overall_mean != r1.overall_mean


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", [0, 17, 41])
def test_single_node_completion_matches_cdf(seed, backend):
    """One worker, whole task: empirical CDF at median ≈ closed form."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.4)
    u = 1.0 / a
    sc = Scenario(a=np.array([[0.4, a]]), u=np.array([[2.5, u]]),
                  gamma=np.array([[1.0, 2 * u]]), L=np.array([100.0]))
    k = np.ones((1, 2))
    plan = Plan(k=k, b=k.copy(), l=np.array([[0.0, 100.0]]),
                t_per_master=np.array([1.0]))
    r = simulate_plan(sc, plan, trials=6000, rng=seed, keep_samples=True,
                      backend=backend, device="cpu")
    med = float(np.median(r.overall_samples))
    c = float(cdf_total(med, 100.0, 1.0, 1.0, a, u, 2 * u))
    assert abs(c - 0.5) < 0.06


# ---------------------------------------------------------------------------
# numpy: bit for bit the reference's stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["coded", "uncoded", "straggle", "chunk"])
def test_numpy_bit_equal_to_reference(case):
    sc, jsc = small_scale_scenario(2), jcore.small_scale_scenario(2)
    if case == "uncoded":
        plan = _uncoded(sc)
        jplan = jcore.Plan(k=plan.k, b=plan.b, l=plan.l,
                           t_per_master=plan.t_per_master, method="uncoded")
    else:
        plan = _plan(sc, 2)
        jplan = jcore.plan_from_assignment(
            jsc, jcore.iterated_greedy(jsc, rng=2))
    assert np.array_equal(plan.l, jplan.l)
    kw = dict(trials=5000, rng=3, keep_samples=True)
    if case == "straggle":
        kw.update(straggle_p=0.1, straggle_factor=6.0)
    if case == "chunk":
        kw.update(chunk=777)
    ours = simulate_plan(sc, plan, **kw)
    ref = jsim.simulate_plan(jsc, jplan, **kw)
    assert ours.overall_mean == ref.overall_mean
    assert np.array_equal(ours.per_master_mean, ref.per_master_mean)
    assert np.array_equal(ours.overall_samples, ref.overall_samples)
    assert np.array_equal(ours.per_master_samples, ref.per_master_samples)


def test_simulate_batch_numpy_bit_equal_to_reference():
    from repro.stream.backend import simulate_batch as jbatch
    sc = small_scale_scenario(3)
    plan = _plan(sc, 3)
    args = (plan.l, plan.k, plan.b, sc.a, sc.u, sc.gamma, sc.L, 3000)
    ours = simulate_batch(*args, seed=4, backend="numpy")
    ref = jbatch(*args, seed=4, backend="numpy")
    assert np.array_equal(ours, ref)


# ---------------------------------------------------------------------------
# torch (on the CPU): statistically the numpy stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["coded", "uncoded", "straggle", "float64"])
def test_torch_agrees_with_numpy_within_4_standard_errors(case):
    sc = large_scale_scenario(0) if case == "coded" \
        else small_scale_scenario(0)
    plan = _uncoded(sc) if case == "uncoded" else _plan(sc, 0)
    kw = dict(keep_samples=True)
    if case == "straggle":
        kw.update(straggle_p=0.1)
    ref = simulate_plan(sc, plan, trials=20_000, rng=1, **kw)
    if case == "float64":
        comp = simulate_batch(plan.l, plan.k, plan.b, sc.a, sc.u, sc.gamma,
                              sc.L, 20_000, seed=2, dtype=torch.float64,
                              chunk=3000, device="cpu")
        over = comp.max(axis=1)
    else:
        res = simulate_plan(sc, plan, trials=20_000, rng=2, backend="torch",
                            device="cpu", chunk=3000, **kw)
        comp, over = res.per_master_samples, res.overall_samples
    assert comp.shape == (20_000, sc.M) and np.isfinite(comp).all()
    se = np.hypot(_sem(over), _sem(ref.overall_samples))
    assert abs(over.mean() - ref.overall_mean) < 4 * se
    for m in range(sc.M):
        se_m = np.hypot(_sem(comp[:, m]), _sem(ref.per_master_samples[:, m]))
        assert abs(comp[:, m].mean() - ref.per_master_mean[m]) < 4 * se_m


def test_torch_needs_all_is_the_slowest_worker():
    """The uncoded rule: completion is the last active worker's arrival,
    never earlier than the coded rule on the same draws."""
    sc = small_scale_scenario(1)
    plan = _plan(sc, 1)
    args = (plan.l, plan.k, plan.b, sc.a, sc.u, sc.gamma, sc.L, 4000)
    coded = simulate_batch(*args, seed=7, device="cpu")
    allw = simulate_batch(*args, seed=7, needs_all=True, device="cpu")
    assert (allw >= coded).all() and (allw > coded).any()


def test_torch_straggle_slows_and_seed_fixes_samples():
    sc = small_scale_scenario(1)
    plan = _plan(sc, 1)
    args = (plan.l, plan.k, plan.b, sc.a, sc.u, sc.gamma, sc.L, 4000)
    base = simulate_batch(*args, seed=7, device="cpu")
    slow = simulate_batch(*args, seed=7, straggle_p=0.2, device="cpu")
    assert slow.mean() > base.mean()
    assert np.array_equal(
        slow, simulate_batch(*args, seed=7, straggle_p=0.2, device="cpu"))
    # a numpy Generator seeds the torch stream through one integer draw
    g1 = simulate_batch(*args, seed=np.random.default_rng(5), device="cpu")
    g2 = simulate_batch(*args, seed=np.random.default_rng(5), device="cpu")
    assert np.array_equal(g1, g2)


def test_torch_simulator_defaults_to_cuda():
    sc = small_scale_scenario(0)
    plan = _plan(sc, 0)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_plan(sc, plan, trials=10, backend="torch")
