"""The port's ``CheckpointManager`` against the reference's: the
reference's roundtrip / keep-k and structure-drift tests mirrored, a
bfloat16 leaf written byte for byte as the reference writes it and read
back bit-exact, checkpoints of (params, AdamW state) written by the
reference after 2 train steps restored by the port (float32: equal
values; bfloat16: equal bits, read by the manifest's dtype), and a
float32 checkpoint written by the port restored by the reference.
"""
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import TokenStream  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.runtime.train_loop import make_train_step as jmake  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ARCH = "llama3.2-1b"


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"data_state": {"step": step}})
    assert mgr.latest_step() == 3
    assert mgr._steps() == [2, 3]            # keep-2 GC
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    restored, step, extra = mgr.restore(tree)
    assert step == 3 and extra["data_state"]["step"] == 3
    assert torch.equal(restored["w"], tree["w"])


def test_checkpoint_structure_drift_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="structure drift"):
        mgr.restore({"w": torch.ones(3), "extra": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_bfloat16_leaf_is_the_references_file_and_roundtrips(tmp_path):
    """A bfloat16 leaf (every bit pattern of a 2-byte range, NaNs and
    infinities included) is written byte for byte as the reference
    writes it ('<V2', manifest dtype "bfloat16") and restores bit-exact
    beside a float32 and an int32 leaf."""
    bits = torch.arange(-32768, 32768, 7, dtype=torch.int32).to(torch.int16)
    tree = {"h": bits.view(torch.bfloat16).reshape(-1, 1),
            "f": torch.linspace(-3, 3, 10), "step": torch.tensor(
                5, dtype=torch.int32)}
    path = CheckpointManager(str(tmp_path / "port")).save(4, tree)
    # the same leaves as numpy arrays, bfloat16 as ml_dtypes' (JAX's)
    ref = JManager(str(tmp_path / "ref")).save(4, jax.tree.map(
        lambda t: t.view(torch.int16).numpy().view(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else t.numpy(), tree))
    for i in range(3):
        name = f"leaf_{i:05d}.npy"
        with open(os.path.join(path, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    back, _, _ = CheckpointManager(str(tmp_path / "port")).restore(tree)
    assert back["h"].dtype == torch.bfloat16
    assert torch.equal(back["h"].view(torch.int16), tree["h"].view(
        torch.int16))
    assert torch.equal(back["f"], tree["f"])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 5


@pytest.fixture(scope="module")
def reference_run():
    """dtype → (params, AdamW state) of the reference after 2 train steps
    of llama3.2 smoke (microbatches 2), written by the reference's
    manager into a directory of its own."""
    out = {}

    def get(dtype, root):
        if dtype not in out:
            cfg = dataclasses.replace(jget_smoke(ARCH), dtype=dtype)
            params = jax.jit(jinit, static_argnums=1)(
                jax.random.PRNGKey(0), cfg)
            opt = jadamw_init(params)
            step = jax.jit(jmake(cfg, n_microbatches=2, lr_peak=3e-3,
                                 warmup=2, total_steps=10))
            stream = TokenStream(vocab=cfg.vocab, seq_len=16,
                                 global_batch=4)
            for s in range(2):
                batch = {k: jnp.asarray(v)
                         for k, v in stream.batch(s).items()}
                params, opt, _ = step(params, opt, batch)
            d = str(root / f"ref_{dtype}")
            JManager(d).save(2, (params, opt),
                             extra={"data_state": stream.state(2)})
            out[dtype] = (cfg, params, opt, d)
        return out[dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_the_references_checkpoint(reference_run,
                                                 tmp_path_factory, dtype):
    """The port's template (its own init, another seed) takes every leaf
    of the reference's checkpoint in order: float32 leaves equal, bfloat16
    leaves equal bit for bit (through the manifest's dtype), the step an
    int32 2, the data state carried."""
    _, params, opt, d = reference_run(dtype,
                                      tmp_path_factory.mktemp("ckpt"))
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    tp = init_model(3, tcfg, device="cpu")
    (rp, ro), step, extra = CheckpointManager(d).restore(
        (tp, adamw_init(tp)))
    assert step == 2 and extra["data_state"]["step"] == 2
    assert int(ro.step) == 2 and ro.step.dtype == torch.int32
    ours = _tree.leaves((rp, ro))
    ref = jax.tree.leaves((params, opt))
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert str(o.dtype).removeprefix("torch.") == str(r.dtype)
        assert tuple(o.shape) == r.shape
        if dtype == "bfloat16" and o.dtype == torch.bfloat16:
            assert np.array_equal(o.view(torch.int16).numpy(),
                                  r.view(np.int16))
        else:
            assert np.array_equal(o.numpy(), r)


def test_reference_restores_the_ports_float32_checkpoint(tmp_path):
    """A float32 (params, AdamW state) written by the port loads into the
    reference's template leaf for leaf."""
    tcfg = get_smoke_config(ARCH)
    tp = init_model(1, tcfg, device="cpu")
    tree = (tp, adamw_init(tp))
    CheckpointManager(str(tmp_path)).save(
        7, tree, extra={"data_state": {"step": 7}})
    jcfg = jget_smoke(ARCH)
    jp = jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    (rp, ro), step, extra = JManager(str(tmp_path)).restore(
        (jp, jadamw_init(jp)))
    assert step == 7 and extra["data_state"]["step"] == 7
    for o, r in zip(_tree.leaves(tree), jax.tree.leaves((rp, ro))):
        assert np.array_equal(o.numpy(), np.asarray(r))
