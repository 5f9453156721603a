"""The port's coded serving (head scope, batched engine) against the
reference bridge, on the same parameters and the same synthetic workload.

To hold the coded layer to the reference bit for bit, the port's bridge
is fed the reference model's hidden states (its prefill/decode functions
are swapped for adapters around the reference's jitted ones, with the
caches carried across as torch tensors): the coded numerics then see the
same inputs, and on the ``"numpy"`` backend the decoded head outputs and
the greedy tokens must be bit-identical.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro.serve_coded.packing as jpacking  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
import repro_torch.serve_coded.packing as tpacking  # noqa: E402
from repro.serve_coded import CodedLinear as JLinear  # noqa: E402
from repro.serve_coded import CodedServingBridge as JBridge  # noqa: E402
from repro.serve_coded import synthetic_requests as jrequests  # noqa: E402
from repro.stream import AdmissionConfig as JAdmission  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve_coded import CodedLinear  # noqa: E402
from repro_torch.serve_coded import CodedServingBridge  # noqa: E402
from repro_torch.serve_coded import synthetic_requests  # noqa: E402
from repro_torch.stream import AdmissionConfig  # noqa: E402
from repro_torch.stream import backend as bk  # noqa: E402

ARCH = "llama3.2-1b"
N_REQ, PROMPT, GEN = 4, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the driver runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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
    yield jcfg, jparams
    tserve._MODEL_CACHE.pop(key)
    if saved is not None:
        tserve._MODEL_CACHE[key] = saved


def _tree(x, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    return leaf(x)


def _reference_hidden_fns(jcfg, jparams):
    """Adapters with the port's (prefill_fn, decode_fn) signature around
    the reference's jitted functions: torch in, torch out."""
    jpf, jdf = jserve.serving_fns(jcfg, return_hidden=True)
    to_j = lambda t: _tree(t, lambda a: jnp.asarray(a.numpy()))  # noqa
    to_t = lambda t: _tree(t, lambda a: torch.from_numpy(  # noqa
        np.array(a)))

    def prefill_fn(_p, batch, caches):
        out = jpf(jparams, {"tokens": jnp.asarray(batch["tokens"].numpy(),
                                                  jnp.int32)}, to_j(caches))
        return tuple(to_t(o) for o in out)

    def decode_fn(_p, toks, pos, caches):
        out = jdf(jparams, jnp.asarray(toks.numpy(), jnp.int32),
                  jnp.asarray(pos.numpy(), jnp.int32), to_j(caches))
        return tuple(to_t(o) for o in out)

    return prefill_fn, decode_fn


def _requests(make, vocab):
    return make(N_REQ, masters=2, vocab=vocab, prompt_len=PROMPT,
                gen_len=GEN, rate=0.02, seed=0)


def _port_bridge(shared, *, reference_hidden=True, **kw):
    jcfg, jparams = shared
    kw.setdefault("backend", "numpy")
    b = CodedServingBridge(masters=2, seed=0, slots_per_master=2,
                           admission=AdmissionConfig(policy="edf"),
                           device="cpu", **kw)
    b._setup_model(PROMPT + GEN + 8)
    if reference_hidden:
        pf, df = _reference_hidden_fns(jcfg, jparams)
        b._model.update(prefill_fn=pf, decode_fn=df)
    return b


def _reference_report(storage):
    b = JBridge(masters=2, seed=0, slots_per_master=2, backend="numpy",
                parity_storage=storage,
                admission=JAdmission(policy="edf"))
    b._setup_model(PROMPT + GEN + 8)
    return b.serve(_requests(jrequests, b._model["cfg"].vocab))


def _recording(monkeypatch, module, store):
    orig = module.PackedStage.execute

    def execute(self, X, **kw):
        out = orig(self, X, **kw)
        store.append({k: np.array(v) for k, v in out.items()})
        return out
    monkeypatch.setattr(module.PackedStage, "execute", execute)


@pytest.mark.parametrize("storage", ["materialized", "virtual"])
def test_numpy_bridge_bit_identical_to_reference(shared_params, storage,
                                                 monkeypatch):
    ref_out, port_out = [], []
    _recording(monkeypatch, jpacking, ref_out)
    ref = _reference_report(storage)
    _recording(monkeypatch, tpacking, port_out)
    b = _port_bridge(shared_params, parity_storage=storage)
    rep = b.serve(_requests(synthetic_requests, 512))
    assert rep.tokens == ref.tokens
    assert rep.solve_steps == ref.solve_steps > 0
    assert rep.max_err == ref.max_err and rep.decode_ok
    assert len(port_out) == len(ref_out) > 0
    for ours, theirs in zip(port_out, ref_out):
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert np.array_equal(ours[k], theirs[k])     # decoded, bitwise
    assert [s["used_solve"] for s in rep.steps] == \
        [s["used_solve"] for s in ref.steps]


@pytest.mark.parametrize("storage", ["materialized", "virtual"])
def test_torch_backend_tokens_equal_and_decode_ok(shared_params, storage):
    ref = _reference_report(storage)
    b = _port_bridge(shared_params, parity_storage=storage, backend="torch",
                     device_products=True)
    rep = b.serve(_requests(synthetic_requests, 512))
    assert rep.tokens == ref.tokens
    assert rep.decode_ok, rep.max_err
    assert rep.backend_effective == "torch"
    assert {s["decode_backend"] for s in rep.steps} == {"torch"}


@pytest.mark.parametrize("storage", ["materialized", "virtual"])
def test_float64_products_keep_tokens_and_shrink_error(shared_params,
                                                       storage):
    """The head repair at smoke size: float64 device products (the
    default) serve the same greedy tokens as the reference's float32 ones,
    both decode_ok, and the float64 decode error is no larger."""
    reps = {}
    for dt in (torch.float32, torch.float64):
        b = _port_bridge(shared_params, parity_storage=storage,
                         backend="torch", device_products=True,
                         product_dtype=dt)
        reps[dt] = b.serve(_requests(synthetic_requests, 512))
    f32, f64 = reps[torch.float32], reps[torch.float64]
    assert f64.tokens == f32.tokens
    assert f32.decode_ok and f64.decode_ok
    assert f64.solve_steps == f32.solve_steps > 0
    assert f64.max_err <= f32.max_err


def test_port_virtual_equals_materialized_and_coded_equals_uncoded(
        shared_params):
    reps = {}
    for storage in ("materialized", "virtual"):
        b = _port_bridge(shared_params, reference_hidden=False,
                         parity_storage=storage)
        reps[storage] = b.serve(_requests(synthetic_requests, 512))
    mat, virt = reps["materialized"], reps["virtual"]
    assert virt.tokens == mat.tokens and virt.max_err == mat.max_err
    assert mat.decode_ok and mat.solve_steps > 0
    unc = _port_bridge(shared_params, reference_hidden=False, coded=False)
    assert unc.serve(_requests(synthetic_requests, 512)).tokens == mat.tokens


# ---------------------------------------------------------------------------
# The decode group: column-restricted blocks, no dense parity rows
# ---------------------------------------------------------------------------

L, D = 48, 16
L_INT = np.array([0, 8, 16, 16, 24, 32])
FINISH = np.array([np.inf, 2.0, 3.0, 99.0, 1.0, 4.0])   # straggler → solve


def _linears(mod_linear, storage, n=1, **kw):
    rng = np.random.default_rng(11)
    W = rng.normal(size=(L, D))
    return [mod_linear(W, name=f"p{i}", seed=i, parity_chunk=8,
                       parity_storage=storage, **kw) for i in range(n)]


def _stage(lins, backend="numpy"):
    probs = []
    for lin in lins:
        plan = lin.prefix_plan(L_INT, FINISH, 4.0)
        probs.append(tpacking.ShardProblem(key=lin.name, linear=lin,
                                           rows=plan.rows,
                                           used_solve=plan.used_solve))
    return tpacking.PackedStage(probs, backend=backend)


@pytest.mark.parametrize("storage", ["materialized", "virtual"])
def test_decode_group_column_restricted_blocks_bit_identical(storage):
    lin, = _linears(CodedLinear, storage)
    stg = _stage([lin])
    grp = stg.groups[0][3][0]
    s = int((grp.sys_pos.shape[1]))
    n_par = L - s
    assert n_par > 8                                 # a real parity solve
    r = stg.problems[0].rows
    # the dense path the reference takes: whole parity rows, then gathers
    Rr = lin.parity_rows(r[r >= L] - L)
    assert np.array_equal(grp.Gk[0], np.ascontiguousarray(Rr[:, grp.sys_rows[0]]))
    assert np.array_equal(grp.lu.A[0], np.ascontiguousarray(Rr[:, grp.unk[0]]))
    assert grp.Gk.flags.c_contiguous and grp.lu.A.flags.c_contiguous


@pytest.mark.parametrize("n", [1, 2])
def test_batched_decode_bit_identical_to_reference_serial_step(n):
    """Held against the reference's *serial* CodedLinear.step (the stacked
    reference path is not contiguous; see ROADMAP queue C)."""
    X = np.random.default_rng(12).normal(size=(3, D))
    port = _linears(CodedLinear, "virtual", n)
    ref = _linears(JLinear, "virtual", n)
    out = _stage(port).execute(X)
    for lin_p, lin_r in zip(port, ref):
        step = lin_r.step(X, L_INT, FINISH, 4.0)
        assert step.used_solve
        assert np.array_equal(out[lin_p.name], step.out)


def test_device_decode_group_matches_numpy_engine(monkeypatch):
    """The torch decode group (minor and substitution term derived in
    small row chunks, float64 LU) tracks the numpy engine."""
    monkeypatch.setattr(tpacking, "DECODE_CHUNK", 64)
    X = np.random.default_rng(13).normal(size=(3, D))
    host = _stage(_linears(CodedLinear, "virtual", 2))
    dev = _stage(_linears(CodedLinear, "virtual", 2, backend="torch",
                          device="cpu"), backend="torch")
    # the same float64 host products into both decodes (the torch
    # backend's own encode is float32)
    dev.pack._W_packed = host.pack.W_packed
    want = host.execute(X)
    got = dev.execute(X)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)


def test_known_term_on_cpu_is_the_row_chunked_float64_product(monkeypatch):
    """On CPU tensors the substitution term keeps its arithmetic bit for
    bit: counter rows over the known columns in row chunks of
    DECODE_CHUNK entries (small here, so several), each widened to
    float64 and times the pinned values (the card fuses the same entries
    into one kernel)."""
    from repro_torch.kernels import ops
    lin, = _linears(CodedLinear, "virtual", backend="torch", device="cpu")
    r = _stage([lin]).problems[0].rows
    mem = tpacking._DeviceMember(lin, r)
    n, m = mem.ctrs.numel(), mem.sys_rows.numel()
    assert n > 8 and m > 8                           # a real parity solve
    y = torch.from_numpy(np.random.default_rng(17).normal(size=(m, 3)))
    monkeypatch.setattr(tpacking, "DECODE_CHUNK", 3 * m + 1)
    step = max(1, tpacking.DECODE_CHUNK // m)
    assert step == 3 and n > 2 * step               # several chunks
    want = torch.cat([ops.counter_parity_rows(
        lin.pkey, L, mem.ctrs[i:i + step], cols=mem.sys_rows).to(
            torch.float64) @ y for i in range(0, n, step)])
    # the row blocks the plain version derives (and multiplies), in order
    import repro_torch.kernels.ref as tref
    blocks, rows = [], tref.counter_parity_rows_ref
    monkeypatch.setattr(tref, "counter_parity_rows_ref",
                        lambda k, s, c, j: blocks.append(c.numel())
                        or rows(k, s, c, j))
    got = mem.known_term(y)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    assert blocks == [min(step, n - i) for i in range(0, n, step)]
    # the kernels' uint32 operands are the counters' bits
    ctrs = lin.parity_ctrs(r[r >= L] - L)
    assert np.array_equal(mem.ctrs.numpy().view(np.uint32), ctrs)


def test_device_path_never_builds_host_buffer():
    lins = _linears(CodedLinear, "virtual", 1, backend="torch", device="cpu")
    stg = _stage(lins, backend="torch")
    X = np.random.default_rng(14).normal(size=(2, D))
    out = stg.execute(X, device_products=True)
    assert stg.pack._W_packed is None
    np.testing.assert_allclose(out["p0"], X @ lins[0].W.T, atol=1e-3)


@pytest.mark.parametrize("storage", ["materialized", "virtual"])
def test_device_products_float64_exact_on_packed_problem(storage):
    """The head repair on a smoke-size packed problem: the device products
    (float32 encoded rows and activations) come out in float64 and agree
    with a float64 numpy product of the same float32 values at 1e-12."""
    lins = _linears(CodedLinear, storage, 2, backend="torch", device="cpu")
    stg = _stage(lins, backend="torch")
    X = np.random.default_rng(15).normal(size=(3, D))
    ys = stg.pack.products_device(X)
    x32 = X.astype(np.float32).astype(np.float64).T
    for p, y in zip(stg.problems, ys):
        assert y.dtype == torch.float64
        lin, r = p.linear, np.asarray(p.rows)
        if storage == "materialized":         # the float32 device mirror
            enc = lin.gather_encoded(r).astype(np.float32)
            want = enc.astype(np.float64) @ x32
        else:                 # systematic rows, then R @ (W @ x) lanes
            W32 = lin.W.astype(np.float32).astype(np.float64)
            sys = r < L
            want = np.empty((r.size, 3))
            want[sys] = W32[r[sys]] @ x32
            want[~sys] = lin.parity_rows(r[~sys] - L) @ (W32 @ x32)
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)


def test_device_W_is_row_major_for_a_transposed_head():
    """An untied head's W is the transpose of the model's output matrix
    (``launch.serve.head_matrix``): the device mirror that the
    generated-parity kernel reads must still be row-major."""
    W = np.random.default_rng(16).normal(size=(D, L)).T      # (L, D), F order
    lin = CodedLinear(W, name="h", seed=0, parity_chunk=8,
                      parity_storage="virtual", backend="torch",
                      device="cpu")
    dw = lin.device_W()
    assert dw.is_contiguous()
    assert np.array_equal(dw.numpy(), W.astype(np.float32))


def test_systematic_rows_take_columns():
    lin, = _linears(CodedLinear, "virtual")
    G = bk.SystematicRows(L, 2 * L, lin.parity_rows)
    rows = np.array([[3, 50, 7], [60, 1, 49]])
    cols = np.array([7, 0, 33, 3])
    assert np.array_equal(G.take(rows, cols), G.take(rows)[..., cols])


def test_lu_factor_torch_in_place_on_column_major():
    rng = np.random.default_rng(15)
    M = rng.normal(size=(6, 6))
    A = torch.empty((6, 6), dtype=torch.float64).mT
    A.copy_(torch.from_numpy(M))
    ptr = A.data_ptr()
    LU, piv = bk.lu_factor_torch(A)
    assert LU.data_ptr() == ptr
    b = rng.normal(size=(6, 2))
    x = bk.lu_solve_torch((LU, piv), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(M @ x, b, atol=1e-10)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_launcher_coded_demo_runs_products_on_the_device(monkeypatch, capsys,
                                                         backend):
    """``python -m repro_torch.launch.serve --coded`` (backend "torch")
    computes its shard products through the packed device product — on
    the CPU only because ``--device cpu`` is given; the numpy backend
    keeps them on the host."""
    from repro_torch.serve_coded import run_coded_smoke
    calls = []
    orig = tpacking.PackedShards.products_device

    def products_device(self, X, **kw):
        calls.append(self.total)
        return orig(self, X, **kw)
    monkeypatch.setattr(tpacking.PackedShards, "products_device",
                        products_device)
    if backend == "torch":
        assert tserve.main(["--coded", "--device", "cpu", "--requests", "2",
                            "--prompt-len", "8", "--gen-len", "2"]) == 0
    else:
        assert run_coded_smoke(backend="numpy", device="cpu", n_requests=2,
                               prompt_len=8, gen_len=2,
                               policies=("edf",)) == 0
    assert "all decoded coded matmuls matched" in capsys.readouterr().out
    assert bool(calls) == (backend == "torch")
