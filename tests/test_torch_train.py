"""The port's training stack against the reference's, on the CPU in
float32: the cosine schedule, ``token_nll``, AdamW (with clipping) and
Adafactor, the loss and its gradients (llama3.2, deepseek-v3 smoke: MLA,
MoE, the MTP loss; rwkv6 smoke: the WKV through the ``wkv6`` operator and
its plain backward), the train step over 3 steps (microbatches + AdamW;
Adafactor), the remat policies, coded gradient aggregation, a bit-equal
resume of ``TrainLoop`` and the launcher.

The parameters are the reference's ``init_model`` tree carried across by
``params_from_numpy``; the batches come from ``TokenStream``.  Each
tolerance is stated beside its check, with margin over the measured
differences (float32 sums in another order: the two frameworks' matmul,
reduction and transcendental kernels differ in the last bits).
"""
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import cosine_warmup as jcosine  # noqa: E402
from repro.parallel.ops import token_nll as jtoken_nll  # noqa: E402
from repro.runtime import coded_grads as jcoded  # noqa: E402
from repro.runtime.train_loop import loss_fn as jloss_fn  # noqa: E402
from repro.runtime.train_loop import make_train_step as jmake  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import wkv6 as twkv6  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import ModelCtx  # noqa: E402
from repro_torch.optim import (adafactor_init, adafactor_update,  # noqa
                               adamw_init, adamw_update, cosine_warmup)
from repro_torch.parallel.ops import token_nll  # noqa: E402
from repro_torch.runtime import coded_grads as tcoded  # noqa: E402
from repro_torch.runtime.train_loop import (TrainLoop,  # noqa: E402
                                            TrainLoopConfig,
                                            make_train_step,
                                            value_and_grad)

LLAMA, DEEPSEEK, RWKV = "llama3.2-1b", "deepseek-v3-671b", "rwkv6-7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch → (jcfg, jparams, tcfg, tparams): the reference's smoke
    init (seed 0), carried to the port."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, tcfg = jget_smoke(arch), get_smoke_config(arch)
            jp = jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
            built[arch] = (jcfg, jp, tcfg, tp)
        return built[arch]
    return get


def _batch(cfg, B=4, T=16, step=0, seed=0):
    raw = TokenStream(vocab=cfg.vocab, seq_len=T, global_batch=B,
                      seed=seed).batch(step)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def _rel_err(ours, ref) -> float:
    """max |ours - ref| / (1e-30 + max |ref|) over one leaf."""
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / (1e-30 + np.abs(b).max())) \
        if b.size else 0.0


def _tree_close(ours, ref, tol: float):
    """Leaf for leaf in ``jax.tree`` order, each within ``tol`` of its
    largest reference entry."""
    ol, rl = _tree.leaves(ours), jax.tree.leaves(ref)
    assert len(ol) == len(rl)
    errs = [_rel_err(o, r) for o, r in zip(ol, rl)]
    assert max(errs) <= tol, (max(errs), errs)
    return max(errs)


# -- schedule, token_nll, optimizers ---------------------------------------

def test_cosine_warmup_matches_reference():
    """Every step 0 .. total + 5, float32 both: within 4 ULP (measured: at
    most 2, from the frameworks' float32 cos)."""
    peak, warmup, total = 3e-3, 5, 40
    ours, ref = cosine_warmup(peak, warmup, total), jcosine(peak, warmup,
                                                            total)
    for s in range(total + 6):
        a, b = ours(s), np.asarray(ref(s))
        assert a.dtype == torch.float32 and b.dtype == np.float32
        assert abs(float(a) - float(b)) <= 4 * np.spacing(np.float32(b)), s
    # a device step tensor stays on its device and type
    assert ours(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_nll_matches_reference(dtype):
    """(B, T, V) logits in either dtype, int32 labels: the per-token nll
    within 1e-6 relative (float32 log-sum-exp in another order; measured
    0 in float32, 4.7e-8 in bfloat16)."""
    rng = np.random.default_rng(0)
    lg = (rng.normal(size=(3, 7, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, size=(3, 7)).astype(np.int32)
    ref = jtoken_nll(jnp.asarray(lg, dtype), jnp.asarray(labels))
    ours = token_nll(torch.from_numpy(lg).to(getattr(torch, dtype)),
                     torch.from_numpy(labels))
    assert ours.dtype == torch.float32
    assert _rel_err(ours, ref) <= 1e-6


def _mixed_tree(rng, scale=1.0):
    """A ≥ 3-D leaf, 1-D leaves, 2-D leaves, in dicts and a list."""
    return {"w3": rng.normal(size=(3, 4, 5)) * scale,
            "b": [rng.normal(size=(7,)) * scale,
                  rng.normal(size=(2, 3)) * scale],
            "emb": {"tok": rng.normal(size=(6, 4)) * scale,
                    "g": rng.normal(size=(4,)) * scale}}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(optimizer):
    """3 steps on a mixed tree, float32, with a cosine lr; the gradients
    are large, so AdamW's clip (norm 1.0) and Adafactor's update clip
    act.  Params and every state leaf within 1e-5 relative (measured
    at most 2.4e-7)."""
    rng = np.random.default_rng(1)
    p0 = jax.tree.map(lambda a: a.astype(np.float32), _mixed_tree(rng))
    grads = [jax.tree.map(lambda a: a.astype(np.float32),
                          _mixed_tree(rng, 30.0)) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.from_numpy, p0)
    lr_j, lr_t = jcosine(1e-2, 2, 10), cosine_warmup(1e-2, 2, 10)
    if optimizer == "adamw":
        js, ts = jadamw.adamw_init(jp), adamw_init(tp)
        jupd, tupd = jadamw.adamw_update, adamw_update
    else:
        js, ts = jadafactor.adafactor_init(jp), adafactor_init(tp)
        jupd, tupd = jadafactor.adafactor_update, adafactor_update
    for g in grads:
        jp, js = jupd(jp, jax.tree.map(jnp.asarray, g), js, lr=lr_j)
        tp, ts = tupd(tp, jax.tree.map(torch.from_numpy, g), ts, lr=lr_t)
        _tree_close(tp, jp, 1e-5)
        _tree_close(ts, js, 1e-5)
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32


# -- loss, gradients, the train step ----------------------------------------

@pytest.mark.parametrize("arch", [LLAMA, DEEPSEEK, RWKV])
def test_loss_and_grads_match_reference(models, arch):
    """``value_and_grad`` of the loss (DeepSeek: with the MTP term; RWKV-6:
    the WKV's gradient from the ``wkv6`` operator's plain backward against
    ``jax``'s autodiff of the chunked form) against ``jax.value_and_grad``
    of the reference's: the loss within 1e-6 relative (measured 7.6e-8),
    every gradient leaf within 2e-5 of its largest entry (float32 through
    the whole stack and its backward; measured 1.8e-6, RWKV-6 2.1e-6)."""
    jcfg, jp, tcfg, tp = models(arch)
    jb, tb = _batch(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jb, cfg=jcfg)))(jp)
    tl, tg = value_and_grad(tp, tb, cfg=tcfg)
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    _tree_close(tg, jg, 2e-5)


def test_loss_mask_matches_reference(models):
    """A ``loss_mask`` weighs the nll as the reference's does."""
    jcfg, jp, tcfg, tp = models(LLAMA)
    jb, tb = _batch(tcfg)
    mask = (np.arange(16)[None, :] % 3 != 0).astype(np.float32).repeat(
        4, 0)
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), \
        torch.from_numpy(mask)
    jl = jloss_fn(jp, jb, cfg=jcfg)
    tl, _ = value_and_grad(tp, tb, cfg=tcfg)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))


@pytest.mark.parametrize("arch,optimizer,n_mb", [
    (LLAMA, "adamw", 2), (DEEPSEEK, "adafactor", 1), (RWKV, "adamw", 2)])
def test_train_step_matches_reference(models, arch, optimizer, n_mb):
    """3 steps of the port's ``make_train_step`` against the reference's
    (jitted) on the same batches: metrics, params and optimizer state.
    The loss within 1e-5 relative; params and state within 2e-4 of each
    leaf's largest entry (measured 2.6e-5: Adam divides a gradient's
    last-bit difference by its small second moment)."""
    jcfg, jp, tcfg, tp = models(arch)
    kw = dict(n_microbatches=n_mb, lr_peak=3e-3, warmup=2, total_steps=10,
              optimizer=optimizer)
    jstep = jax.jit(jmake(jcfg, **kw))
    tstep = make_train_step(tcfg, **kw)
    if optimizer == "adamw":
        js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    else:
        js, ts = jadafactor.adafactor_init(jp), adafactor_init(tp)
    for step in range(3):
        jb, tb = _batch(tcfg, step=step)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert int(tm["step"]) == int(jm["step"]) == step + 1
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-9
        assert abs(float(tm["loss"]) - float(jm["loss"])) \
            <= 1e-5 * abs(float(jm["loss"]))
    _tree_close(tp, jp, 2e-4)
    _tree_close(ts, js, 2e-4)


@pytest.mark.parametrize("arch", [DEEPSEEK, RWKV])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policy_gives_bit_equal_grads(models, policy, arch):
    """Recomputing a repeat of the block (whole, or all but its matmuls)
    gives the gradients of the forward that keeps everything, bit for
    bit (DeepSeek smoke: MLA, MoE, a prefix layer and MTP; RWKV-6 smoke:
    the ``wkv6`` operator run again under the checkpoint's dispatch mode)."""
    _, _, tcfg, tp = models(arch)
    _, tb = _batch(tcfg)
    l0, g0 = value_and_grad(tp, tb, cfg=tcfg, ctx=ModelCtx("none"))
    l1, g1 = value_and_grad(tp, tb, cfg=tcfg, ctx=ModelCtx(policy))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(g0),
                                                  _tree.leaves(g1)))


def test_tree_order_is_jax_order(models):
    """The port's leaf order is ``jax.tree``'s on the parameter tree (a
    prefix list, stacked blocks, nested dicts) and on the optimizer
    states (NamedTuples), which the clip norm and the checkpoint index
    rely on."""
    _, jp, _, tp = models(DEEPSEEK)
    for ours, ref in ((tp, jp),
                      (adamw_init(tp), jadamw.adamw_init(jp)),
                      (adafactor_init(tp), jadafactor.adafactor_init(jp))):
        ol, rl = _tree.leaves(ours), jax.tree.leaves(ref)
        assert [tuple(o.shape) for o in ol] == [r.shape for r in rl]
        for o, r in zip(ol, rl):
            assert np.array_equal(_np(o), np.asarray(r, np.float64))


def test_tree_walks_hold_no_reference_cycle():
    """flatten / unflatten / map leave nothing for the cyclic collector:
    with it off, the leaves die with their last tree (a reference cycle
    held a train step's gradients on the card until a collection)."""
    import gc
    import weakref
    tree = {"a": [torch.zeros(8)], "s": adamw_init({"w": torch.ones(3)})}
    refs = [weakref.ref(t) for t in _tree.leaves(tree)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        leaves, skeleton = _tree.flatten(tree)
        back = _tree.unflatten(skeleton, leaves)
        mapped = _tree.map(lambda t, u: t + u, tree, back)
        assert len(_tree.leaves(mapped)) == len(refs) == 4
        del tree, leaves, back, mapped
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


# -- coded gradient aggregation ---------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_coded_grads_match_reference(int8, monkeypatch):
    """4 group gradients → 6 coded shards (G from the same seed), any 4
    arrived: the coded matrix within 1e-6 of its largest entry (float32
    K = 4 sums), its systematic rows bit for bit; the aggregate within
    2e-6 of the reference's (a float32 4 x 4 solve for the combination
    weights against the reference's solve for the shards; measured
    2.3e-7) and of the plain sum (without int8: 2e-6, measured 1.8e-7;
    with int8 the quantization dominates: 5e-2, measured 1.6e-2), each
    relative to the leaf's largest entry.  Column chunks give the same
    aggregate, bit for bit."""
    rng = np.random.default_rng(0)
    trees = [jax.tree.map(lambda a: a.astype(np.float32),
                          _mixed_tree(rng)) for _ in range(4)]
    jc, jctx = jcoded.encode_grad_shards(
        [jax.tree.map(jnp.asarray, t) for t in trees], n_coded=6, rng=1)
    tc, tctx = tcoded.encode_grad_shards(
        [jax.tree.map(torch.from_numpy, t) for t in trees], n_coded=6, rng=1)
    assert np.array_equal(tctx["G"].numpy(), np.asarray(jctx["G"]))
    assert _rel_err(tc, jc) <= 1e-6
    assert np.array_equal(tc[:4].numpy(), np.asarray(jc[:4]))
    arrived = [0, 2, 4, 5]
    ja = jcoded.coded_grad_aggregate(jc, jctx, arrived, compress_int8=int8)
    ta = tcoded.coded_grad_aggregate(tc, tctx, arrived, compress_int8=int8)
    _tree_close(ta, ja, 2e-6)
    truth = jax.tree.map(lambda *xs: np.sum(xs, axis=0), *trees)
    _tree_close(ta, truth, 5e-2 if int8 else 2e-6)
    monkeypatch.setattr(tcoded, "CHUNK_COLS", 7)
    chunked = tcoded.coded_grad_aggregate(tc, tctx, arrived,
                                          compress_int8=int8)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(chunked),
                                                  _tree.leaves(ta)))
    with pytest.raises(ValueError, match="need 4"):
        tcoded.coded_grad_aggregate(tc, tctx, [0, 5])


# -- the loop, the launcher, the WKV off the CPU ----------------------------

def _loop(ckpt_dir, seed=0):
    cfg = get_smoke_config(LLAMA)
    stream = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=4,
                         seed=0)
    return TrainLoop(cfg, TrainLoopConfig(
        total_steps=6, ckpt_every=3, ckpt_dir=str(ckpt_dir),
        n_microbatches=2, lr_peak=3e-3, warmup=5, keep=2), stream,
        rng_seed=seed, device="cpu")


def test_resume_equals_straight_run_bit_for_bit(tmp_path):
    """``TrainLoop`` over 6 steps with a checkpoint every 3; the step-6
    checkpoint is dropped (a preemption before it), and a fresh loop with
    another seed restores step 3 and runs to 6: every param and moment
    leaf equals the straight run's, bit for bit."""
    straight = _loop(tmp_path)
    hist = straight.run()
    assert [s for s, _ in hist] == [6]
    assert straight.ckpt._steps() == [3, 6]
    shutil.rmtree(tmp_path / "step_00000006")
    resumed = _loop(tmp_path, seed=7)
    assert resumed.try_restore() and resumed.step == 3
    resumed.run()
    assert resumed.step == 6
    for a, b in zip(_tree.leaves((straight.params, straight.opt_state)),
                    _tree.leaves((resumed.params, resumed.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: 20 steps (the
    loop logs every 10, so the first and last logged losses are steps 10
    and 20) improve the loss and exit 0; ``--resume`` with 40 steps
    continues from the step-20 checkpoint."""
    args = ["--device", "cpu", "--seq", "16", "--batch", "4",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "10",
            "--hetero-profile", "ec2"]
    assert tlaunch.main(args + ["--steps", "20"]) == 0
    out = capsys.readouterr().out
    assert "[hetero] Thm-1 split over 8 groups" in out
    assert "improved" in out and "NOT" not in out
    assert tlaunch.main(args + ["--steps", "40", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 20" in out
    assert "step    30" in out and "step    10" not in out


def test_launcher_trains_rwkv(tmp_path, capsys):
    """``--arch rwkv6-7b --device cpu``: the smoke RWKV-6 trains through
    the ``wkv6`` operator (the plain forward and backward on CPU tensors),
    and 20 steps improve the loss and exit 0."""
    assert tlaunch.main(["--arch", RWKV, "--device", "cpu", "--steps", "20",
                         "--seq", "32", "--batch", "4", "--ckpt-dir",
                         str(tmp_path), "--ckpt-every", "20"]) == 0
    out = capsys.readouterr().out
    assert "arch=rwkv6-smoke" in out
    assert "improved" in out and "NOT" not in out


def test_wkv6_trains_off_the_cpu_through_the_kernel():
    """Off the CPU a training call goes through the ``wkv6`` operator,
    never to the plain version: meta tensors (which stand in for the
    card's here), neither the CPU's nor fake, are refused at its device
    check, with grad and without."""
    def inputs(grad):
        t = [torch.empty((2, 4, 8), device="meta", requires_grad=grad)
             for _ in range(4)]
        return t + [torch.empty((2, 8), device="meta")]
    with pytest.raises(ValueError, match="expected a tensor on"):
        twkv6.wkv6_dev(*inputs(True))
    with torch.no_grad():
        with pytest.raises(ValueError, match="expected a tensor on"):
            twkv6.wkv6_dev(*inputs(True))
    with pytest.raises(ValueError, match="expected a tensor on"):
        twkv6.wkv6_dev(*inputs(False))
