"""The port's streaming engine (``repro_torch.stream.StreamingExecutor``)
against the reference's (``repro.stream.StreamingExecutor``).

Everything but the verification numerics is the reference's host numpy,
so a same-seed ``"numpy"`` run must give the reference's ``summary()`` key
for key, churn included.  The ``"torch"`` verification (kernel wrappers
and the on-device decode, here on the CPU through their plain float64
versions) must leave every delay metric where the numpy run puts it and
decode every task at the 1e-6 tolerance; the fault detector, which reads
the verified products, must count what the reference counts.
"""
import numpy as np
import pytest
import torch

from repro.core.problem import Scenario as JScenario
from repro.faults import FaultConfig as JFaultConfig
from repro.stream import BackendConfig as JBackendConfig
from repro.stream import PoissonProcess as JPoisson
from repro.stream import StreamConfig as JStreamConfig
from repro.stream import StreamingExecutor as JStreaming
from repro.stream import WorkerEvent as JWorkerEvent
from repro_torch.core.problem import Scenario
from repro_torch.faults import FaultConfig
from repro_torch.stream import (BackendConfig, PoissonProcess, StreamConfig,
                                StreamingExecutor, WorkerEvent)

DELAY_KEYS = ("tasks_completed", "sojourn_p50", "sojourn_p99",
              "queue_wait_mean", "replans")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the driver runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _a(M=2, N=8, seed=5):
    rng = np.random.default_rng(seed)
    a = np.zeros((M, N + 1))
    a[:, 0] = 0.5
    a[:, 1:] = rng.uniform(0.2, 0.4, size=(M, N))
    return a


def _port_run(backend="numpy", numerics="verify", faults=None, n=30):
    """The reference's backend-equivalence case (``tests/test_stream.py``)
    on the port."""
    a = _a()
    sc = Scenario(a=a, u=1 / a, gamma=2 / a, L=np.full(a.shape[0], 48.0))
    srcs = [PoissonProcess(m, rate=0.01, seed=1) for m in range(sc.M)]
    ex = StreamingExecutor(sc, srcs, config=StreamConfig(
        policy="fractional", rng=11,
        backend=BackendConfig(backend=backend, numerics=numerics)),
        churn=[WorkerEvent(150.0, 2, "degrade", 4.0),
               WorkerEvent(300.0, 5, "leave")],
        faults=faults, device="cpu")
    return ex, ex.run(max_tasks=n)


def _reference_run(numerics="verify", faults=None, n=30):
    a = _a()
    sc = JScenario(a=a, u=1 / a, gamma=2 / a, L=np.full(a.shape[0], 48.0))
    srcs = [JPoisson(m, rate=0.01, seed=1) for m in range(sc.M)]
    ex = JStreaming(sc, srcs, config=JStreamConfig(
        policy="fractional", rng=11,
        backend=JBackendConfig(backend="numpy", numerics=numerics)),
        churn=[JWorkerEvent(150.0, 2, "degrade", 4.0),
               JWorkerEvent(300.0, 5, "leave")],
        faults=faults)
    return ex, ex.run(max_tasks=n)


@pytest.mark.parametrize("numerics", ["none", "verify"])
def test_numpy_summary_equals_reference(numerics):
    _, ours = _port_run(numerics=numerics)
    _, theirs = _reference_run(numerics=numerics)
    s_t, s_j = ours.summary(), theirs.summary()
    assert s_t.keys() == s_j.keys()
    for k in s_j:
        assert s_t[k] == s_j[k], k
    assert ours.to_records() == theirs.to_records()


def test_torch_verify_keeps_delay_metrics_and_decodes():
    _, ms_np = _port_run("numpy")
    _, ms_t = _port_run("torch")
    s_np, s_t = ms_np.summary(), ms_t.summary()
    assert s_t["decode_ok_rate"] == 1.0
    for k in DELAY_KEYS:
        assert s_t[k] == s_np[k], k
    errs = [r["max_err"] for r in ms_t.to_records()]
    assert max(errs) < 1e-9


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_fault_detection_counters_equal_reference(backend):
    kw = dict(seed=3, corrupt_rate=0.3, drop_rate=0.05, stale_rate=0.05)
    ex_t, ms_t = _port_run(backend, faults=FaultConfig(**kw))
    ex_j, _ = _reference_run(faults=JFaultConfig(**kw))
    assert ex_t.fault_stats == ex_j.fault_stats
    assert ex_j.fault_stats["corruptions_applied"] > 0
    assert ms_t.summary()["tasks_completed"] == 30


def test_config_backends_are_the_ports():
    assert BackendConfig(backend="torch").backend == "torch"
    for be in ("jax", "pallas"):
        with pytest.raises(ValueError, match="backend"):
            BackendConfig(backend=be)


def _decode_case(L, form, seed=3):
    """A systematic generator (shared, stacked or a list) and received rows
    that give one scatter task, one mixed task and one all-parity task."""
    rng = np.random.default_rng(seed)
    Lt = 2 * L
    gens = [np.vstack([np.eye(L), rng.standard_normal((Lt - L, L))])
            for _ in range(3)]
    rows = np.stack([rng.permutation(L),
                     np.concatenate([rng.choice(L, L // 2, replace=False),
                                     L + rng.choice(L, L - L // 2,
                                                    replace=False)]),
                     L + rng.choice(Lt - L, L, replace=False)])
    y = rng.standard_normal((3, L, 2))
    G = {"shared": gens[0], "stacked": np.stack(gens), "list": gens}[form]
    return G, rows, y


@pytest.mark.parametrize("systematic", ["auto", "prefix", "never"])
@pytest.mark.parametrize("form", ["shared", "stacked", "list"])
@pytest.mark.parametrize("L", [24, 512])
def test_torch_decode_batch_matches_reference(L, form, systematic):
    """The torch engine builds its plan on the device (here the CPU) and
    decodes what the reference's numpy engine decodes: scatter rows equal
    bit for bit, solves at 1e-9 relative; a released plan regathers its
    blocks to the same result.  L = 512 takes the one-system-at-a-time
    LU."""
    from repro.stream.backend import decode_batch as j_decode_batch
    from repro_torch.stream import backend as bk
    G, rows, y = _decode_case(L, form)
    want = j_decode_batch(G, rows, y, systematic=systematic)
    plan = bk.plan_decode(G, rows, systematic=systematic, device="cpu")
    got = plan.apply(y, backend="torch", release=True)
    assert np.array_equal(got, plan.apply(y, backend="torch"))  # regathered
    assert np.array_equal(got, bk.decode_batch(G, rows, y, backend="torch",
                                               systematic=systematic,
                                               device="cpu"))
    scale = 1 + np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-9 * scale
    if systematic != "never":
        assert np.array_equal(got[0], want[0])           # the scatter
    if plan.full_idx.size:
        assert plan.full_G.mT.is_contiguous()            # factored in place
    with pytest.raises(ValueError):
        plan.apply(y, backend="numpy")
