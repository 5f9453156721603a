"""The port's analysis tools (``repro_torch.launch.{roofline, analytic,
specs, steps}``) against the reference's, on the CPU.

* ``analytic.estimate`` equals the reference's (relative 1e-12) for every
  config × shape cell × mesh × option, and ``terms()`` differs only by the
  H100's constants; ``roofline.model_flops`` equals the reference's;
* ``input_specs`` / ``input_shardings`` / ``microbatches_for`` /
  ``model_state_shapes`` equal the reference's (the shardings through the
  stub mesh of ``test_torch_sharding.py``), the stand-ins fake tensors;
* the FLOPs a :class:`StepTrace` counts over the port's forward against
  ``estimate`` (the analogue of ``tests/test_analytic.py``: smoke configs
  at one repeat, B 2 × T 64, within 0.35 for the dense configs and in
  (0.3, 2.0) for dbrx; and llama3.2-1b at its published widths and
  depth), and against ``FlopCounterMode`` over the same step run for real;
* the WKV operator (``torch.ops.repro_torch.wkv6`` and ``wkv6_bwd``)
  through ``torch.library.opcheck``, and its FLOP formula.

Every model is fake: nothing is allocated.
"""
import dataclasses
import functools

import pytest
import torch

jax = pytest.importorskip("jax")

import repro.parallel.sharding as jsh  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.config import SHAPE_CELLS  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import analytic, roofline, specs, steps  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
#: estimate's options: (name, keyword arguments); train cells at 8
#: microbatches in each
OPTIONS = {"remat_full": {}, "remat_dots": dict(remat_policy="dots"),
           "ep_full": dict(ep_full=True), "a2a_fp8": dict(a2a_fp8=True),
           "no_fsdp": dict(fsdp=False), "no_remat": dict(remat=False)}
MESH_DESCS = ((16, 16), (32, 16), (1, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """What the rules read of a mesh: its dim names and sizes."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


class _Named:
    """The reference's ``NamedSharding(mesh, spec)``, recorded."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_matches_reference(arch, option):
    cfg, jcfg = get_config(arch), jget_config(arch)
    kw = OPTIONS[option]
    for cell in SHAPE_CELLS:
        for dp, tp in MESH_DESCS:
            n_micro = 8 if cell.kind == "train" else 1
            got = analytic.estimate(cfg, cell, analytic.MeshDesc(dp, tp),
                                    n_micro=n_micro, **kw)
            want = janalytic.estimate(jcfg, cell,
                                      janalytic.MeshDesc(dp, tp),
                                      n_micro=n_micro, **kw)
            where = (cell.name, dp, tp)
            for name in ("flops", "hbm_bytes", "ici_bytes"):
                assert _rel(getattr(got, name), getattr(want, name)) \
                    <= 1e-12, (name, where)
            assert got.breakdown.keys() == want.breakdown.keys(), where
            for k, v in want.breakdown.items():
                assert _rel(got.breakdown[k], v) <= 1e-12, (k, where)
            assert analytic.expert_param_count(cfg) == \
                janalytic.expert_param_count(jcfg)
            assert analytic._kv_cache_bytes(cfg, cell) == \
                janalytic._kv_cache_bytes(jcfg, cell)


def test_terms_differ_only_by_the_constants():
    """``terms()`` reads one H100 SXM5's published peaks; the reference's
    formulas given the same constants give the same terms."""
    assert roofline.HW == dict(peak_flops=989.4e12, hbm_bw=3.35e12,
                               ici_bw=450e9)
    for arch in ("llama3_2_1b", "deepseek_v3_671b", "rwkv6_7b"):
        for cell in SHAPE_CELLS:
            mesh = analytic.MeshDesc(16, 16)
            got = analytic.estimate(get_config(arch), cell, mesh).terms()
            want = janalytic.estimate(jget_config(arch), cell, mesh).terms(
                peak=989.4e12, hbm=3.35e12, ici=450e9)
            assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_matches_reference(arch):
    for cell in SHAPE_CELLS:
        assert roofline.model_flops(get_config(arch), cell) == \
            jroofline.model_flops(jget_config(arch), cell)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _leaf_sig(t):
    """(shape, dtype name) of a tensor, a ``(shape, dtype)`` template or
    a ``jax.ShapeDtypeStruct``."""
    if isinstance(t, tuple):
        return tuple(t[0]), _dtype_name(t[1])
    return tuple(t.shape), _dtype_name(t.dtype)


def _is_template(t) -> bool:
    return isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], tuple)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    from torch._subclasses.fake_tensor import is_fake
    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in SHAPE_CELLS:
        got = specs.input_specs(cfg, cell, device="cpu")
        want = jspecs.input_specs(jcfg, cell)
        assert sorted(got) == sorted(want), cell.name
        for k in want:
            g = _tree.leaves(got[k], is_leaf=_is_template)
            w = jax.tree.leaves(want[k])
            assert [_leaf_sig(t) for t in g] == [_leaf_sig(t) for t in w], \
                (cell.name, k)
            if k != "caches":
                assert is_fake(got[k]), (cell.name, k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_shardings_match_reference(arch, mesh, monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", _Named)
    m = _Mesh(MESHES[mesh])
    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in SHAPE_CELLS:
        got = specs.input_shardings(specs.input_specs(cfg, cell,
                                                      device="cpu"),
                                    m, cell)
        want = jspecs.input_shardings(jspecs.input_specs(jcfg, cell), m,
                                      cell)
        assert sorted(got) == sorted(want)
        for k in want:
            g = [tuple(s) for s in _tree.leaves(got[k], is_leaf=lambda t:
                                                isinstance(t, tuple))]
            w = [tuple(n.spec) for n in jax.tree.leaves(
                want[k], is_leaf=lambda t: isinstance(t, _Named))]
            assert g == w and w, (cell.name, k)


@pytest.mark.parametrize("override", [None, 1, 4])
@pytest.mark.parametrize("mesh", MESHES)
def test_microbatches_match_reference(mesh, override):
    m = _Mesh(MESHES[mesh])
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for cell in SHAPE_CELLS:
            assert specs.microbatches_for(cfg, cell, m, override) == \
                jspecs.microbatches_for(jcfg, cell, m, override), \
                (arch, cell.name)


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str, opt: str):
    dtype = {"adamw_bf16": "bfloat16", "adamw_none": None,
             "adafactor": None}[opt]
    optimizer = "adafactor" if opt == "adafactor" else "adamw"
    return jsteps.model_state_shapes(jget_config(arch),
                                     opt_state_dtype=dtype,
                                     optimizer=optimizer), dtype, optimizer


@pytest.mark.parametrize("opt", ["adamw_bf16", "adamw_none", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_state_shapes_match_reference(arch, opt):
    """Params and optimizer state leaf by leaf (``jax.tree`` order) against
    ``jax.eval_shape`` of the reference's init, every leaf a fake tensor
    on the requested device."""
    from torch._subclasses.fake_tensor import is_fake
    (jp, jo), dtype, optimizer = _ref_state(arch, opt)
    p, o = steps.model_state_shapes(get_config(arch), opt_state_dtype=dtype,
                                    optimizer=optimizer, device="cpu")
    got = _tree.leaves((p, o))
    want = jax.tree.leaves((jp, jo))
    assert [_leaf_sig(t) for t in got] == [_leaf_sig(t) for t in want]
    assert all(is_fake(t) for t in got)


def test_model_state_shapes_stand_in_on_the_card():
    """On a fake CUDA device the stand-ins carry the device and no
    storage: the draw runs fake on the CPU, the stand-ins are factory
    calls (no card is needed)."""
    from torch._subclasses.fake_tensor import is_fake
    p, o = steps.model_state_shapes(get_config("llama3_2_1b"),
                                    opt_state_dtype="bfloat16",
                                    device="cuda")
    leaves = _tree.leaves((p, o))
    assert all(is_fake(t) and t.device.type == "cuda" for t in leaves)


def _fwd_flops(cfg, B: int, T: int) -> int:
    """FLOPs a StepTrace counts over the port's ``model_fwd`` on fake
    parameters and inputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import model_fwd
    fake = FakeTensorMode()
    params, _ = steps.model_state_shapes(cfg, opt_state_dtype=None,
                                         device="cpu", fake_mode=fake)
    batch = {k: v for k, v in specs.input_specs(
        cfg, ShapeCell("tiny", T, B, "train"), device="cpu",
        fake_mode=fake).items() if k != "labels"}
    with fake, torch.no_grad(), roofline.StepTrace() as trace:
        model_fwd(params, batch, cfg=cfg)
    return trace.flops


def _est_fwd(cfg, B: int, T: int) -> float:
    return analytic.estimate(cfg, ShapeCell("tiny", T, B, "prefill"),
                             analytic.MeshDesc(1, 1)).breakdown[
        "flops_fwd_global"]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "nemotron_4_15b",
                                  "glm4_9b"])
def test_fwd_flops_match_counted_dense(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), n_repeats=1)
    got = _fwd_flops(cfg, 2, 64)
    est = _est_fwd(cfg, 2, 64)
    assert got > 0
    assert abs(est - got) / got < 0.35, (arch, est, got)


def test_fwd_flops_match_counted_moe():
    cfg = dataclasses.replace(get_smoke_config("dbrx_132b"), n_repeats=1)
    got = _fwd_flops(cfg, 2, 64)
    est = _est_fwd(cfg, 2, 64)
    # the MoE's capacity padding counts more; stay in band
    assert 0.3 < est / got < 2.0, (est, got)


def test_fwd_flops_match_counted_at_full_depth():
    """llama3.2-1b at its published widths and depth: the eager count
    runs every repeat, so the estimate is held at full depth too."""
    cfg = get_config("llama3_2_1b")
    got = _fwd_flops(cfg, 2, 64)
    est = _est_fwd(cfg, 2, 64)
    assert abs(est - got) / got < 0.35, (est, got)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "rwkv6_7b"])
def test_traced_step_flops_equal_flop_counter_mode(arch):
    """A train step (2 microbatches, remat, AdamW) traced on fake tensors
    counts what ``FlopCounterMode`` counts over the same step run for real
    (the WKV by its registered formula); the trace's memory holds the
    arguments and peaks above them."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_train_step
    cfg = get_smoke_config(arch)
    cell = ShapeCell("tiny", 16, 4, "train")
    rep, n_micro, _, _ = trace_cell(cfg, cell, None, "cpu", microbatches=2,
                                    opt_state_dtype=None)
    params = init_model(0, cfg, device="cpu")
    batch = {k: torch.zeros((4, 16), dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, n_microbatches=2)
    with FlopCounterMode(display=False) as fc:
        step(params, adamw_init(params), batch)
    assert n_micro == 2
    assert rep.flops_per_device == fc.get_total_flops() > 0
    ma = rep.memory_analysis
    n_bytes = sum(t.numel() * t.element_size() for t in _tree.leaves(params))
    assert ma["params_bytes"] == n_bytes
    assert ma["opt_state_bytes"] >= 2 * n_bytes
    assert ma["peak_size_in_bytes"] > ma["argument_size_in_bytes"]
    assert rep.t_memory > 0 and rep.t_compute > 0 and rep.t_collective == 0


def _wkv_args(T: int, grad: bool):
    g = torch.Generator().manual_seed(0)
    BH, H, K = 4, 2, 8

    def n(*s):
        return torch.randn(s, generator=g)
    r, k, v = (n(BH, T, K) for _ in range(3))
    w = torch.rand((BH, T, K), generator=g) * 0.5 + 0.4
    u, s0 = 0.1 * n(H, K), n(BH, K, K)
    for t in (r, k, v, w, u, s0):
        t.requires_grad_(grad)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T", [1, 5])
def test_wkv6_operator_passes_opcheck(T):
    from repro_torch.kernels import wkv6
    r, k, v, w, u, s0 = _wkv_args(T, grad=True)
    torch.library.opcheck(wkv6.wkv6_op, (r, k, v, w, u, s0, 4))
    torch.library.opcheck(wkv6.wkv6_op, (r, k, v, w, u, None, 4))


def test_wkv6_bwd_operator_passes_opcheck():
    from repro_torch.kernels import wkv6
    r, k, v, w, u, s0 = _wkv_args(5, grad=False)
    do = torch.randn_like(v)
    dS = torch.randn_like(s0)
    args = (r, k, v, w, u, s0)
    torch.library.opcheck(wkv6.wkv6_bwd_op, (*args, do, dS))
    torch.library.opcheck(wkv6.wkv6_bwd_op, (*args[:5], None, do, None))


def test_wkv6_flop_formula_reads_the_route_counts():
    """The formulas credit ``plan.wkv6_ops`` / ``wkv6_bwd_ops`` (the
    counts ``chip_smoke.py``'s bounds read) on the operands' shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import plan, wkv6
    for T in (1, 5):
        r, k, v, w, u, s0 = _wkv_args(T, grad=True)
        with FlopCounterMode(display=False) as fc:
            out, s = wkv6.wkv6_dev(r, k, v, w, u, s0, chunk=4)
        fwd = plan.wkv6_ops(T, 8, 8, 4, 4)[0]
        assert fc.get_total_flops() == int(fwd)
        with FlopCounterMode(display=False) as fc:
            (out.sum() + s.sum()).backward()
        bwd = plan.wkv6_bwd_ops(T, 8, 8, 4, 4,
                                plan.wkv6_bwd_plan(T, 8, 8, 4).chunk)
        assert fc.get_total_flops() == int(sum(bwd.values()))
