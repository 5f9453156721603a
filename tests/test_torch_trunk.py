"""The port's ffn and trunk coding scopes (``HostTrunk``) against the
reference, on the same weights and the same synthetic workload.

The port's bridge serves the reference's smoke parameters (converted with
``params_from_numpy`` and seeded into the port's model memo), so the two
float64 host trunks see the same weights: on the ``"numpy"`` backend the
whole serve — greedy tokens, step timings, ``max_err`` and every decoded
product — is held to the reference bit for bit on the serial engine.  The
batched engine decodes stacked groups through contiguous blocks where the
reference gathers them column by column (ROADMAP queue C), so its
decoded products are held to 1e-12 where such a group forms.
"""
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro.serve_coded.coded_linear as jlinear  # noqa: E402
import repro.serve_coded.packing as jpacking  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
import repro_torch.serve_coded.coded_linear as tlinear  # noqa: E402
import repro_torch.serve_coded.packing as tpacking  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.serve_coded import CodedServingBridge as JBridge  # noqa: E402
from repro.serve_coded import HostTrunk as JHostTrunk  # noqa: E402
from repro.serve_coded import synthetic_requests as jrequests  # noqa: E402
from repro.serve_coded import trunk_matmul_keys as jkeys  # noqa: E402
from repro.stream import AdmissionConfig as JAdmission  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve_coded import (CodedServingBridge, HostTrunk,  # noqa
                                     synthetic_requests, trunk_matmul_keys)
from repro_torch.stream import AdmissionConfig, WorkerEvent  # noqa: E402

ARCH = "llama3.2-1b"
N_REQ, PROMPT, GEN = 4, 16, 3


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


@pytest.fixture(scope="module")
def shared_params():
    """The reference's smoke parameters, also seeded into the port's model
    memo so the port's bridge serves the very same weights."""
    jcfg, jparams = jserve.build_model(ARCH, smoke=True, seed=0)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    key = (ARCH, True, 0, "cpu")
    saved = tserve._MODEL_CACHE.pop(key, None)
    tserve._MODEL_CACHE[key] = (tcfg, tparams)
    yield jcfg, jparams, tcfg, tparams
    tserve._MODEL_CACHE.pop(key)
    if saved is not None:
        tserve._MODEL_CACHE[key] = saved


def _trunks(shared):
    jcfg, jparams, tcfg, tparams = shared
    ref = JHostTrunk(jcfg, jparams, jserve.head_matrix(jcfg, jparams))
    port = HostTrunk(tcfg, tparams, tserve.head_matrix(tcfg, tparams))
    return ref, port


# ---------------------------------------------------------------------------
# HostTrunk: weights, hidden states, caches, keys
# ---------------------------------------------------------------------------

def test_host_trunk_weights_bit_equal_to_reference(shared_params):
    ref, port = _trunks(shared_params)
    assert port.weights.keys() == ref.weights.keys()
    for k, w in ref.weights.items():
        assert port.weights[k].dtype == np.float64
        assert port.weights[k].strides == w.strides, k     # same layout
        assert np.array_equal(port.weights[k], w), k
    assert np.array_equal(port.embed, ref.embed)
    assert np.array_equal(port.final_norm, ref.final_norm)
    for (a1, a2), (b1, b2) in zip(port.norms, ref.norms):
        assert np.array_equal(a1, b1) and np.array_equal(a2, b2)


def test_host_trunk_prefill_and_decode_bit_identical(shared_params):
    """A prefill and two batched decode steps with local matmuls: the
    hidden states, every layer's residual stream and the KV caches equal
    the reference's bit for bit."""
    ref, port = _trunks(shared_params)
    cfg = shared_params[2]
    rng = np.random.default_rng(3)
    P, B = 12, 2
    caches = {"ref": ref.zero_caches(B, P + 4),
              "port": port.zero_caches(B, P + 4)}
    hid = {"ref": [], "port": []}
    for who, tr in (("ref", ref), ("port", port)):
        rng = np.random.default_rng(3)
        layers = []
        for s in range(B):                              # prefill per slot
            prompt = rng.integers(0, cfg.vocab, size=(1, P))
            hid[who].append(tr.forward(prompt, np.arange(P)[None],
                                       np.array([s]), caches[who],
                                       collect=layers))
        toks = rng.integers(0, cfg.vocab, size=(B, 1))
        for step in range(2):                           # batched decode
            pos = np.full((B, 1), P + step)
            hid[who].append(tr.forward(toks, pos, np.arange(B), caches[who],
                                       collect=layers))
            toks = np.argmax(tr.local_matmul("head", hid[who][-1][:, 0]),
                             axis=1)[:, None]
        hid[who].append(layers)
    for a, b in zip(hid["port"][:-1], hid["ref"][:-1]):
        assert np.array_equal(a, b)
    assert len(hid["port"][-1]) == 4 * cfg.n_repeats
    for a, b in zip(hid["port"][-1], hid["ref"][-1]):
        assert np.array_equal(a, b)
    for k in ("k", "v"):
        assert np.array_equal(caches["port"][k], caches["ref"][k])


def _host_trunk_applies(cfg) -> bool:
    if cfg.enc_dec or cfg.mla is not None or cfg.frontend is not None:
        return False
    specs = list(cfg.prefix) + list(cfg.block) * cfg.n_repeats
    return all(s.mixer == "attn" and s.ffn != "moe" for s in specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_trunk_matmul_keys_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if not _host_trunk_applies(cfg):
        with pytest.raises(NotImplementedError):
            HostTrunk(cfg, {}, np.zeros((1, 1)))
        return
    for scope in ("head", "ffn", "trunk"):
        assert trunk_matmul_keys(cfg, scope) == jkeys(jcfg, scope)
    with pytest.raises(ValueError):
        trunk_matmul_keys(cfg, "everything")


def test_rwkv6_trunk_scope_raises_not_implemented():
    b = CodedServingBridge(arch="rwkv6-7b", coding_scope="trunk",
                           device="cpu")
    with pytest.raises(NotImplementedError, match="attn\\+dense"):
        b._setup_model(16)


# ---------------------------------------------------------------------------
# The scope × backend × execution matrix against the reference bridge
# ---------------------------------------------------------------------------

def _record_serial(monkeypatch, module, store):
    orig = module.CodedLinear.step

    def step(self, X, *a, **kw):
        res = orig(self, X, *a, **kw)
        store.append((self.name, np.array(res.out)))
        return res
    monkeypatch.setattr(module.CodedLinear, "step", step)


def _record_batched(monkeypatch, module, store):
    orig = module.PackedStage.execute

    def execute(self, X, **kw):
        out = orig(self, X, **kw)
        # a stacked group: two or more problems decoded by one solve
        stacked = any(not getattr(sub, "perm", False) and sub.sel.size > 1
                      for _, _, _, subs in self.groups for sub in subs)
        store.append(({k: np.array(v) for k, v in out.items()}, stacked))
        return out
    monkeypatch.setattr(module.PackedStage, "execute", execute)


_REF = {}


def _reference(scope, execution):
    """The JAX bridge's serve, memoised with its decoded products."""
    key = (scope, execution)
    if key not in _REF:
        store = []
        with pytest.MonkeyPatch.context() as mp:
            if execution == "serial":
                _record_serial(mp, jlinear, store)
            else:
                _record_batched(mp, jpacking, store)
            b = JBridge(masters=2, seed=0, slots_per_master=2,
                        coding_scope=scope, backend="numpy",
                        execution=execution,
                        admission=JAdmission(policy="edf"))
            b._setup_model(PROMPT + GEN + 8)
            rep = b.serve(jrequests(N_REQ, masters=2,
                                    vocab=b._model["cfg"].vocab,
                                    prompt_len=PROMPT, gen_len=GEN,
                                    rate=0.02, seed=0))
        _REF[key] = (rep, store)
    return _REF[key]


def _port(scope, execution, backend="numpy", **kw):
    b = CodedServingBridge(masters=2, seed=0, slots_per_master=2,
                           coding_scope=scope, backend=backend,
                           execution=execution,
                           admission=AdmissionConfig(policy="edf"),
                           device="cpu", **kw)
    b._setup_model(PROMPT + GEN + 8)
    return b.serve(synthetic_requests(N_REQ, masters=2,
                                      vocab=b._model["cfg"].vocab,
                                      prompt_len=PROMPT, gen_len=GEN,
                                      rate=0.02, seed=0))


@pytest.mark.parametrize("execution", ["serial", "batched"])
@pytest.mark.parametrize("scope", ["ffn", "trunk"])
def test_numpy_scope_serve_matches_reference(shared_params, scope, execution,
                                             monkeypatch):
    ref, ref_out = _reference(scope, execution)
    port_out = []
    if execution == "serial":
        _record_serial(monkeypatch, tlinear, port_out)
    else:
        _record_batched(monkeypatch, tpacking, port_out)
    rep = _port(scope, execution)
    assert rep.tokens == ref.tokens
    assert [s["t_done"] for s in rep.steps] == \
        [s["t_done"] for s in ref.steps]
    assert [s["used_solve"] for s in rep.steps] == \
        [s["used_solve"] for s in ref.steps]
    assert rep.decode_ok and rep.solve_steps == ref.solve_steps > 0
    assert len(port_out) == len(ref_out) > 0
    if execution == "serial":
        assert rep.max_err == ref.max_err
        for (kp, yp), (kr, yr) in zip(port_out, ref_out):
            assert kp == kr and np.array_equal(yp, yr), kp
        return
    assert abs(rep.max_err - ref.max_err) <= 1e-12
    # a stacked decode's last-bit differences flow on through the
    # residual stream and the caches: bit-equality holds up to the first
    # stacked group of the serve
    inexact = False
    for (ours, stacked), (theirs, _) in zip(port_out, ref_out):
        inexact |= stacked
        assert ours.keys() == theirs.keys()
        for k in ours:
            if inexact:
                np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                           atol=1e-12)
            else:
                assert np.array_equal(ours[k], theirs[k]), k
    if scope == "ffn":     # this workload forms no stacked ffn group
        assert not inexact


@pytest.mark.parametrize("execution", ["serial", "batched"])
@pytest.mark.parametrize("scope", ["ffn", "trunk"])
def test_torch_scope_serve_tokens_equal_reference(shared_params, scope,
                                                  execution):
    """The card's path on the CPU: device products (through the kernels'
    plain versions) and the torch decode give the reference's greedy
    tokens, and the port's coded serve equals its uncoded twin."""
    ref, _ = _reference(scope, execution)
    kw = dict(device_products=True, parity_storage="virtual")
    rep = _port(scope, execution, backend="torch", **kw)
    assert rep.tokens == ref.tokens
    assert rep.decode_ok and rep.argmax_match_rate == 1.0
    assert rep.solve_steps > 0
    assert {s["decode_backend"] for s in rep.steps} == {"torch"}
    plain = _port(scope, execution, backend="torch", coded=False, **kw)
    assert plain.tokens == rep.tokens and plain.decode_ok is None
    assert [s["t_done"] for s in plain.steps] == \
        [s["t_done"] for s in rep.steps]


def test_device_products_run_on_the_trunk_views(shared_params, monkeypatch):
    """Every trunk weight is a transposed (column-major) view: the device
    products read its row-major float32 mirror, and every trunk key's
    stage reaches the packed device product."""
    seen = set()
    orig = tpacking.PackedShards.products_device

    def products_device(self, X, **kw):
        seen.update(p.key for p in self.problems)
        return orig(self, X, **kw)
    monkeypatch.setattr(tpacking.PackedShards, "products_device",
                        products_device)
    b = CodedServingBridge(masters=1, seed=0, slots_per_master=2,
                           coding_scope="trunk", backend="torch",
                           device_products=True, parity_storage="virtual",
                           device="cpu")
    b._setup_model(PROMPT + GEN + 8)
    for key in trunk_matmul_keys(b._model["cfg"], "trunk"):
        lin = b._linears[key]
        assert lin.W.flags.f_contiguous and not lin.W.flags.c_contiguous
        dw = lin.device_W()
        assert dw.is_contiguous()
        assert np.array_equal(dw.numpy(), lin.W.astype(np.float32))
    rep = b.serve(synthetic_requests(2, masters=1,
                                     vocab=b._model["cfg"].vocab,
                                     prompt_len=8, gen_len=2, rate=0.02,
                                     seed=0))
    assert rep.decode_ok
    assert seen == set(b._coded_keys)


# ---------------------------------------------------------------------------
# Multi-token dispatch and churn (the reference's trunk-scope cases)
# ---------------------------------------------------------------------------

def _serve(scope, *, coded=True, steps=1, churn=(), n=4, gen=3):
    b = CodedServingBridge(masters=2, seed=0, slots_per_master=2,
                           coding_scope=scope, steps_per_dispatch=steps,
                           backend="numpy", coded=coded,
                           admission=AdmissionConfig(policy="edf"),
                           device="cpu")
    b._setup_model(16 + gen + 8)
    reqs = synthetic_requests(n, masters=2, vocab=b._model["cfg"].vocab,
                              prompt_len=16, gen_len=gen, rate=0.02, seed=0)
    return b.serve(reqs, churn=churn)


def test_steps_per_dispatch_preserves_trunk_tokens(shared_params):
    one = _serve("trunk", steps=1, gen=4)
    two = _serve("trunk", steps=2, gen=4)
    assert two.tokens == one.tokens
    assert len(two.steps) < len(one.steps)
    assert two.decode_ok and one.decode_ok
    assert two.tokens_generated == one.tokens_generated == 16
    plain = _serve("trunk", coded=False, steps=2, gen=4)
    assert two.tokens == plain.tokens


def test_churn_retimes_in_flight_trunk_steps_tokens_unchanged(shared_params):
    churn = [WorkerEvent(100.0, 2, "degrade", 6.0),
             WorkerEvent(250.0, 5, "leave"),
             WorkerEvent(2500.0, 5, "join"),
             WorkerEvent(4000.0, 2, "restore")]
    coded = _serve("trunk", churn=churn, n=6)
    plain = _serve("trunk", coded=False, churn=churn, n=6)
    assert coded.decode_ok
    assert coded.tokens == plain.tokens
    assert coded.summary()["tasks_completed"] == 6
    assert coded.metrics.replans >= 2


def test_mass_leave_redispatches_in_flight_trunk_step(shared_params):
    churn = [WorkerEvent(60.0, w, "leave") for w in range(1, 9)]
    coded = _serve("trunk", churn=churn)
    plain = _serve("trunk", coded=False, churn=churn)
    assert coded.summary()["tasks_completed"] == 4
    assert coded.redispatches > 0
    assert coded.tokens == plain.tokens and coded.decode_ok


def test_scope_task_fanout(shared_params):
    """ffn codes head + FFN, trunk also q/k/v/o — the per-step task
    count — and both stay exact on numpy."""
    expect = {"ffn": 1 + 3 * 2, "trunk": 1 + 7 * 2}
    for scope, n_tasks in expect.items():
        rep = _serve(scope)
        assert rep.decode_ok and rep.max_err < 1e-6, scope
        assert {s["n_tasks"] for s in rep.steps} == {n_tasks}
