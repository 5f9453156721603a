"""The fault layer on the port's bridge: the reference's chaos matrix
(``tests/test_faults.py``, serving bridge) in trunk scope.

Delivery faults (crash / drop / stale / duplicate) only change which rows
arrive when, so greedy tokens equal the fault-free serve's.  Corruptions
are detected by residual checks of surplus deliveries and two audit rows,
localised by re-dispatch exclusion, the culprits quarantined, and the
step decoded back to the exact product — or reported ``degraded``, never
silently wrong.  On the serial ``"numpy"`` engine each fault report's
counters also equal the JAX bridge's on the same weights and schedule.
"""
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.faults as jfaults  # noqa: E402
import repro.launch.serve as jserve  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
from repro.serve_coded import CodedServingBridge as JBridge  # noqa: E402
from repro.serve_coded import synthetic_requests as jrequests  # noqa: E402
from repro.stream import AdmissionConfig as JAdmission  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.faults import (CORRUPTION_FAULTS, DELIVERY_FAULTS,  # noqa
                                FaultConfig)
from repro_torch.serve_coded import (CodedServingBridge,  # noqa: E402
                                     synthetic_requests)
from repro_torch.stream import AdmissionConfig  # noqa: E402

ARCH = "llama3.2-1b"
MAX_LEN = 16 + 3 + 8
DELIVERY_RATES = {"crash": dict(crash_rate=0.1), "drop": dict(drop_rate=0.2),
                  "stale": dict(stale_rate=0.3),
                  "duplicate": dict(duplicate_rate=0.3)}
#: every counter of the report that the serial engines must share
COUNTERS = ("injected", "crashes", "drops", "stales", "duplicates",
            "corrupt_steps", "corrupt_applied", "detected", "localized",
            "retries", "rows_rejected", "false_flags", "detection_rate",
            "localization_rate", "quarantines", "readmissions",
            "degraded_steps", "suspect_replans")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one BLAS thread: several test processes run at once,
    and the thread pools thrash when oversubscribed (the float64 host
    products here run faster on one thread than on eight shared ones)."""
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


@pytest.fixture(autouse=True, scope="module")
def shared_params():
    """The reference's smoke parameters, seeded into the port's model memo:
    both bridges serve the very same weights."""
    jcfg, jparams = jserve.build_model(ARCH, smoke=True, seed=0)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    key = (ARCH, True, 0, "cpu")
    saved = tserve._MODEL_CACHE.pop(key, None)
    tserve._MODEL_CACHE[key] = (tcfg, tparams)
    yield
    tserve._MODEL_CACHE.pop(key)
    if saved is not None:
        tserve._MODEL_CACHE[key] = saved


def _serve(*, execution="batched", backend="numpy", scope="trunk", **kw):
    if backend == "torch":
        kw.setdefault("device_products", True)
        kw.setdefault("parity_storage", "virtual")
    b = CodedServingBridge(masters=2, slots_per_master=2, coding_scope=scope,
                           backend=backend, execution=execution,
                           admission=AdmissionConfig(policy="edf"),
                           device="cpu", **kw)
    b._setup_model(MAX_LEN)
    rep = b.serve(synthetic_requests(4, masters=2,
                                     vocab=b._model["cfg"].vocab,
                                     prompt_len=16, gen_len=3, rate=0.02,
                                     seed=0))
    return rep, {r: list(t) for r, t in rep.tokens.items()}


_CLEAN = {}


def _clean_tokens(execution, backend="numpy", scope="trunk"):
    key = (execution, backend, scope)
    if key not in _CLEAN:
        _CLEAN[key] = _serve(execution=execution, backend=backend,
                             scope=scope)[1]
    return _CLEAN[key]


def _faulted(fc, **kw):
    rep, got = _serve(faults=fc, **kw)
    clean = _clean_tokens(kw.get("execution", "batched"),
                          kw.get("backend", "numpy"), kw.get("scope",
                                                             "trunk"))
    return rep, got == clean


def _reference_faults(fields):
    b = JBridge(masters=2, slots_per_master=2, coding_scope="trunk",
                backend="numpy", execution="serial",
                admission=JAdmission(policy="edf"),
                faults=jfaults.FaultConfig(**fields))
    b._setup_model(MAX_LEN)
    rep = b.serve(jrequests(4, masters=2, vocab=b._model["cfg"].vocab,
                            prompt_len=16, gen_len=3, rate=0.02, seed=0))
    return rep


def _same_as_reference(rep, fields):
    ref = _reference_faults(fields)
    assert {r: list(t) for r, t in rep.tokens.items()} == \
        {r: list(t) for r, t in ref.tokens.items()}
    for k in COUNTERS:
        assert rep.faults[k] == ref.faults[k], k
    assert rep.decode_modes == ref.decode_modes


def _check_corruption(rep, same):
    f = rep.faults
    degraded = (rep.decode_modes or {}).get("degraded", 0)
    assert same or degraded > 0                 # never silently wrong
    if f["corrupt_applied"] > 0:
        assert f["detection_rate"] >= 0.99
        assert f["localization_rate"] >= 0.99
        assert f["quarantines"] > 0
        assert f["readmissions"] <= f["quarantines"]
    assert f["false_flags"] == 0


@pytest.mark.parametrize("execution", ["serial", "batched"])
@pytest.mark.parametrize("kind", DELIVERY_FAULTS)
def test_delivery_faults_keep_tokens_bit_identical(kind, execution):
    fields = dict(seed=3, **DELIVERY_RATES[kind])
    rep, same = _faulted(FaultConfig(**fields), execution=execution)
    assert same and rep.decode_ok
    assert (rep.decode_modes or {}).get("degraded", 0) == 0
    assert rep.faults["injected"] > 0
    if execution == "serial":
        _same_as_reference(rep, fields)


@pytest.mark.parametrize("execution", ["serial", "batched"])
@pytest.mark.parametrize("kind", CORRUPTION_FAULTS)
def test_corruption_detected_localised_and_recovered(kind, execution):
    fields = dict(seed=5, corrupt_rate=0.3, corrupt_kind=kind,
                  retry_budget=4)
    rep, same = _faulted(FaultConfig(**fields), execution=execution)
    _check_corruption(rep, same)
    assert rep.faults["corrupt_applied"] > 0
    if execution == "serial":
        _same_as_reference(rep, fields)


def test_corruption_recovers_on_torch_backend():
    """The card's path on the CPU: device products through the plain
    versions, the torch decode and the bridge's wider torch tolerance."""
    fc = FaultConfig(seed=5, corrupt_rate=0.3, corrupt_kind="sign_flip",
                     retry_budget=4)
    rep, same = _faulted(fc, backend="torch")
    assert same and rep.decode_ok
    _check_corruption(rep, same)
    assert rep.faults["corrupt_applied"] > 0


def test_fault_free_schedule_with_detection_armed_is_identity():
    for execution in ("serial", "batched"):
        rep, same = _faulted(FaultConfig(seed=0), execution=execution)
        assert same and rep.decode_ok
        f = rep.faults
        assert f["injected"] == 0 and f["false_flags"] == 0
        assert f["detection_rate"] == 1.0 and f["localization_rate"] == 1.0
        assert set(rep.decode_modes) == {"exact"}


def test_exhausted_retry_budget_degrades_explicitly():
    fields = dict(seed=5, corrupt_rate=0.3, corrupt_kind="sign_flip",
                  retry_budget=0)
    rep, same = _faulted(FaultConfig(**fields), execution="serial")
    if not same:
        assert (rep.decode_modes or {}).get("degraded", 0) > 0
        assert rep.faults["rows_rejected"] > 0
    assert rep.faults["detection_rate"] >= 0.99
    _same_as_reference(rep, fields)


def test_quarantine_and_backoff_readmission_cycle():
    fields = dict(seed=3, crash_rate=0.1, backoff_base=500.0)
    rep, same = _faulted(FaultConfig(**fields), execution="serial")
    f = rep.faults
    assert same and f["quarantines"] > 0
    assert f["readmissions"] == f["quarantines"]
    _same_as_reference(rep, fields)


def test_ls_tail_is_bit_identical_at_exact_rows():
    for execution in ("serial", "batched"):
        rep, got = _serve(execution=execution, ls_tail=True)
        assert got == _clean_tokens(execution)
        assert rep.decode_ok
        assert set(rep.decode_modes) == {"ls"}


@pytest.mark.parametrize("fields", [
    dict(seed=3, drop_rate=0.2),
    dict(seed=5, corrupt_rate=0.3, corrupt_kind="bit_flip", retry_budget=4),
], ids=["drop", "bit_flip"])
def test_head_scope_faults(fields):
    """The head scope on the port's own model: one delivery fault and one
    corruption, each held to the port's clean head-scope serve."""
    rep, same = _faulted(FaultConfig(**fields), scope="head")
    assert rep.faults["injected"] > 0
    if "drop_rate" in fields:
        assert same and rep.decode_ok
    else:
        _check_corruption(rep, same)


@pytest.mark.parametrize("n_par", [0, 5, 20])
def test_device_recovery_decode_and_residuals_match_host(n_par):
    """The fault layer's on-card recovery pieces for virtual parity (here
    through the kernels' plain versions on the CPU): the decode of an
    arbitrary L-row set and the per-row residuals agree with the host
    plans over the lazy generator."""
    from repro_torch.serve_coded import CodedLinear
    from repro_torch.serve_coded.packing import (DeviceRowsDecode,
                                                 device_verify_residuals)
    from repro_torch.stream import backend as bk
    rng = np.random.default_rng(n_par)
    L, D, C = 48, 16, 3
    W = rng.normal(size=(L, D))
    kw = dict(name="t", seed=1, parity_chunk=8, parity_storage="virtual")
    host = CodedLinear(W, **kw)
    dev = CodedLinear(W, backend="torch", device="cpu", **kw)
    host.ensure_parity(40)
    dev.ensure_parity(40)
    G = bk.SystematicRows(L, L + 40, host.parity_rows)
    keep = rng.permutation(L)[:L - n_par]
    rows = rng.permutation(np.concatenate(
        [keep, L + rng.permutation(40)[:n_par]]))
    X = rng.normal(size=(C, D))
    y = G.take(rows) @ (W @ X.T)                      # (L, C) products
    want = bk.plan_decode(G, rows[None]).apply(y[None])
    got = DeviceRowsDecode(dev, rows).apply(y[None])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[0], W @ X.T, rtol=0, atol=1e-9)
    chk = np.concatenate([rows, L + np.arange(40, 44)])
    dev.ensure_parity(44)
    host.ensure_parity(44)
    G = bk.SystematicRows(L, L + 44, host.parity_rows)
    yc = G.take(chk) @ (W @ X.T)
    yc[3] += 1.0                                      # one corrupted row
    ref = bk.plan_verify(G, chk[None]).residuals(got, yc[None])
    res = device_verify_residuals(dev, chk, got[0], yc)
    np.testing.assert_allclose(res, ref[0], rtol=0, atol=1e-9)
    assert (res > 1e-4).tolist() == [i == 3 for i in range(chk.size)]
