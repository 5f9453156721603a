"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's, leaf by leaf, for every config at its published widths;
and the port's meshes (``repro_torch.launch.mesh``) on torch's fake
process group.

The reference is called with a stub mesh that carries ``.shape`` and
``.axis_names`` (its ``NamedSharding`` swapped for a record of the spec),
so no device exists for either side; the shapes come from ``jax.eval_shape``
of the reference's init, so nothing is allocated.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.parallel.sharding as jsh  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import init_cache_shapes as jcache_shapes  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim.adafactor import adafactor_init  # noqa: E402
from repro.optim.adamw import adamw_init  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_cache_shapes  # noqa: E402
from repro_torch.optim import adafactor as tadafactor  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
MODES = {"fsdp": dict(fsdp=True), "no_fsdp": dict(fsdp=False),
         "moe_full_ep": dict(moe_full_ep=True)}


class _Mesh:
    """What the rules read of a mesh: its dim names and sizes."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


class _Named:
    """The reference's ``NamedSharding(mesh, spec)``, recorded."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture(autouse=True)
def _recorded_named_sharding(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", _Named)


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg))


def _ref_specs(tree) -> list:
    return [tuple(n.spec) for n in jax.tree.leaves(
        tree, is_leaf=lambda t: isinstance(t, _Named))]


def _port_specs(tree) -> list:
    return [tuple(s) for s in _tree.leaves(tree, is_leaf=sh.is_spec)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, mode):
    shapes = _shapes(arch)
    m = _Mesh(MESHES[mesh])
    want = _ref_specs(jsh.param_shardings(shapes, m, **MODES[mode]))
    got = sh.param_shardings(shapes, m, **MODES[mode])
    paths = [p for p, _ in sh._paths(shapes)]
    assert len(want) == len(paths)
    # the rules shard something on every mesh with a model dim
    assert any(any(e is not None for e in s) for s in want)
    by_path = dict(zip(sorted(paths), want))   # jax.tree: sorted keys
    for (path, _), spec in zip(sh._paths(shapes), sh._paths(got)):
        assert tuple(spec[1]) == by_path[path], path


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh, batch):
    """Batch over the data dims when it divides, else the sequence axis
    (the long-context single request); a heads-like dim on "model"."""
    m = _Mesh(MESHES[mesh])
    ref = jsh.cache_shardings(
        jcache_shapes(jget_config(arch), batch, 4096), m, batch)
    got = sh.cache_shardings(init_cache_shapes(get_config(arch), batch,
                                               4096), m, batch)
    want = _ref_specs(ref)
    assert _port_specs(got) == want and want


def _port_state(ref_state):
    """The reference's optimizer-state shapes in the port's NamedTuples."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        if type(t).__name__ == "_Factored":
            return tadafactor._Factored(row=t.row, col=t.col)
        return t
    if hasattr(ref_state, "mu"):
        return tadamw.OptState(step=ref_state.step, mu=conv(ref_state.mu),
                               nu=conv(ref_state.nu))
    return tadafactor.AdafactorState(step=ref_state.step,
                                     second=conv(ref_state.second))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_match_reference(arch, mesh, opt):
    """AdamW's moments mirror the parameters; Adafactor's factored row
    and column drop the reduced dim."""
    shapes = _shapes(arch)
    m = _Mesh(MESHES[mesh])
    init = adamw_init if opt == "adamw" else adafactor_init
    state = jax.eval_shape(init, shapes)
    want = _ref_specs(jsh.opt_state_shardings(
        state, jsh.param_shardings(shapes, m)))
    got = sh.opt_state_shardings(_port_state(state),
                                 sh.param_shardings(shapes, m))
    assert _port_specs(got) == want


def test_batch_specs_match_reference():
    for name, shape in MESHES.items():
        m = _Mesh(shape)
        for bshape in ((32, 128), (16, 128), (1, 4096), (4, 16, 8)):
            assert tuple(sh.batch_sharding(m, bshape)) == \
                tuple(jsh.batch_sharding(m, bshape).spec), (name, bshape)
        assert sh.data_axes_of(m) == jsh.data_axes_of(m)


def test_placements_split_a_dim_over_several_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard

    class _DM:
        mesh_dim_names = ("pod", "data", "model")
    spec = sh.PartitionSpec(None, ("pod", "data"), "model")
    assert sh.placements(spec, _DM()) == (Shard(1), Shard(1), Shard(2))
    assert sh.placements(sh.PartitionSpec(), _DM()) == (Replicate(),) * 3


@pytest.fixture
def fake_world():
    """torch's fake process group: ``world`` ranks in one process."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(fake_world, multi_pod):
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    world = 512 if multi_pod else 256
    fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    if multi_pod:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
    else:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
    with pytest.raises(ValueError, match=f"needs {512 if not multi_pod else 256} ranks"):
        make_production_mesh(multi_pod=not multi_pod, device_type="cpu")
    local = make_local_mesh(4, device_type="cpu")
    assert tuple(local.shape) == (world // 4, 4)
    assert local.mesh_dim_names == ("data", "model")
    # the rules read a DeviceMesh as they read the reference's mesh
    assert sh.mesh_shape(mesh) == dict(zip(mesh.mesh_dim_names,
                                           tuple(mesh.shape)))


def test_mesh_module_touches_no_process_group():
    import importlib
    import torch.distributed as dist
    import repro_torch.launch.mesh as mesh_mod
    importlib.reload(mesh_mod)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_local_mesh()


def test_sharded_embed_without_a_mesh_is_the_plain_gather():
    from repro_torch.parallel.ops import sharded_embed
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(64, 8)))
    tokens = torch.from_numpy(rng.integers(0, 64, size=(3, 5)))
    assert torch.equal(sharded_embed(table, tokens, None), table[tokens])
