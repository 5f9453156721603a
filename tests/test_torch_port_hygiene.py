"""Port hygiene: the copied numpy modules cannot drift from the reference,
the port never imports jax or the reference package, and its entry points
run on ``cuda`` unless the caller names the CPU."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

COPIED = sorted(
    [f"core/{p.name}" for p in (REF / "core").glob("*.py")]
    + ["sim/cluster.py", "parallel/hetero.py", "faults/__init__.py",
       "serve_coded/requests.py", "serve_coded/plan_cache.py",
       "models/config.py", "data/__init__.py", "data/pipeline.py",
       "runtime/straggler.py"]
    + [f"stream/{m}.py" for m in ("events", "metrics", "queueing",
                                   "barrier", "replan")]
    + [f"obs/{m}.py" for m in ("tracer", "export", "validate")])
CONFIGS = sorted(p.name for p in (REF / "configs").glob("*.py"))


def test_copied_module_list_is_complete():
    assert len([c for c in COPIED if c.startswith("core/")]) == 8


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_byte_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


def test_stream_config_differs_only_by_the_backends():
    """The port's stream config is the reference's with the backends the
    port has: ``"torch"`` in place of ``"jax"`` / ``"pallas"``."""
    ref = (REF / "stream" / "config.py").read_text()
    old = '_BACKENDS = ("numpy", "jax", "pallas")\n'
    assert ref.count(old) == 1
    assert (PORT / "stream" / "config.py").read_text() == ref.replace(
        old, '_BACKENDS = ("numpy", "torch")\n')


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_differ_only_by_the_package_path(name):
    ref = (REF / "configs" / name).read_text()
    want = ref.replace("from repro.models.config import",
                       "from repro_torch.models.config import").replace(
        'f"repro.configs.{key}"', 'f"repro_torch.configs.{key}"')
    assert (PORT / "configs" / name).read_text() == want


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


def test_entry_points_default_to_cuda():
    from repro_torch.core import (large_scale_scenario, plan_from_assignment,
                                  simple_greedy)
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.launch.serve import build_model
    from repro_torch.models import init_model
    from repro_torch.runtime import (CodedExecutor, TrainLoop,
                                     TrainLoopConfig)
    from repro_torch.serve_coded import CodedServingBridge
    from repro_torch.stream import StreamingExecutor
    if torch.cuda.is_available():
        _, params = build_model("llama3.2-1b", smoke=True, seed=0)
        assert params["final_norm"].is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        build_model("llama3.2-1b", smoke=True, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(0, get_smoke_config("rwkv6-7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        CodedServingBridge()
    sc = large_scale_scenario(0)
    with pytest.raises(RuntimeError, match="cuda"):
        CodedExecutor(sc, plan_from_assignment(sc, simple_greedy(sc)),
                      backend="torch")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingExecutor(sc)
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="cuda"):
        TrainLoop(cfg, TrainLoopConfig(), TokenStream(cfg.vocab, 8, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("llama3.2-1b", "decode_32k", False)
    _, params = build_model("llama3.2-1b", smoke=True, seed=0, device="cpu")
    assert params["final_norm"].device.type == "cpu"
