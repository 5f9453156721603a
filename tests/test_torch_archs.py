"""The six configs that the remaining mixers bring to the port (MoE, MLA +
MTP, hybrid Mamba, sliding windows, vision frontend, encoder-decoder)
against the reference, on the same parameters (the port's seeded draw,
carried to the reference), at their smoke widths in float32 on the CPU:
the full forward, prefill + decode (logits, hidden states, every cache
leaf), the init tree, the converter's dtypes, the uncoded serve loop's
greedy tokens, and the coded bridge (head scope for DeepSeek and Jamba,
trunk scope for Gemma-3, the enc-dec refusal).
Tolerance: 1e-4 × (1 + max |ref|), as ``test_torch_models.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache_shapes as jcache_shapes  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import model_fwd as jfwd  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.lm import ModelCtx, _encoder as jencoder  # noqa: E402
from repro.serve_coded import CodedServingBridge as JBridge  # noqa: E402
from repro.serve_coded import synthetic_requests as jrequests  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import (decode_step, init_model,  # noqa: E402
                                model_fwd, prefill)
from repro_torch.models.lm import _encoder as tencoder  # noqa: E402
from repro_torch.serve_coded import CodedServingBridge  # noqa: E402
from repro_torch.serve_coded import synthetic_requests  # noqa: E402

TOL = 1e-4
ARCHS = ["deepseek-v3-671b", "dbrx-132b", "jamba-1.5-large-398b",
         "gemma3-12b", "internvl2-26b", "seamless-m4t-large-v2"]
MOE = ["deepseek-v3-671b", "dbrx-132b", "jamba-1.5-large-398b"]


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
    """arch → (jcfg, jparams, tcfg, tparams): one smoke model, drawn by the
    port's ``init_model`` (seed 0) and carried to the reference as JAX
    arrays — the reference's eager init takes seconds a model.  Both
    launchers' model memos hold it while the module runs, so both bridges
    serve the same weights."""
    built, saved = {}, {}

    def get(arch):
        if arch not in built:
            tcfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
            tp = init_model(0, tcfg, device="cpu")
            jp = _to_jax(tp)
            for memo, key, entry in (
                    (tserve._MODEL_CACHE, (arch, True, 0, "cpu"),
                     (tcfg, tp)),
                    (jserve._MODEL_CACHE, (arch, True, 0), (jcfg, jp))):
                saved[id(memo), key] = (memo, key, memo.pop(key, None))
                memo[key] = entry
            built[arch] = (jcfg, jp, tcfg, tp)
        return built[arch]

    yield get
    for memo, key, old in saved.values():
        memo.pop(key)
        if old is not None:
            memo[key] = old


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


#: prefill / decode shapes shared by the cache checks and the greedy loop,
#: so each reference config compiles one prefill and one decode step
B, P, G = 2, 9, 4
ML = P + G + 8                       # the launcher's cache length


@functools.lru_cache(maxsize=None)
def _jfns(jcfg):
    """The reference's prefill and decode step, jitted once a config."""
    return (jax.jit(functools.partial(jprefill, cfg=jcfg,
                                      return_hidden=True)),
            jax.jit(functools.partial(jdecode, cfg=jcfg,
                                      return_hidden=True)))


def _capped(cfg, factor):
    if factor is None or cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * (1.0 + np.abs(b).max())


def _batch(cfg, B, T, seed):
    """Tokens, and the frontend's features, both ways."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(B, T))}
    if cfg.enc_dec:
        b["enc_feats"] = rng.normal(size=(B, cfg.frontend_len,
                                          cfg.frontend_dim))
    if cfg.frontend == "vision":
        b["patch_feats"] = rng.normal(size=(B, cfg.frontend_len,
                                            cfg.frontend_dim))
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in b.items()}
    tb = {k: torch.from_numpy(v if k == "tokens" else v.astype(np.float32))
          for k, v in b.items()}
    return jb, tb


def _flat(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _jflat(tree):
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _trees_close(ttree, jtree):
    ours, ref = list(_flat(ttree)), _jflat(jtree)
    assert [p for p, _ in ours] == [p for p, _ in sorted(ref)]
    for (p, t), (_, j) in zip(ours, sorted(ref, key=lambda e: e[0])):
        if p[-1] == "len":
            assert np.array_equal(t.numpy(), np.asarray(j)), p
        else:
            _close(t.numpy(), j)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,factor", [(a, None) for a in ARCHS]
                         + [(a, 64.0) for a in MOE])
def test_model_fwd_matches_reference(models, arch, factor):
    jcfg, jp, tcfg, tp = models(arch)
    jcfg, tcfg = _capped(jcfg, factor), _capped(tcfg, factor)
    jb, tb = _batch(tcfg, 2, 11, seed=1)
    ref = jax.jit(functools.partial(jfwd, cfg=jcfg))(jp, jb)
    ours = model_fwd(tp, tb, cfg=tcfg)
    assert ours.keys() == ref.keys()
    assert ("mtp_logits" in ours) == tcfg.mtp
    for k in ours:
        _close(ours[k].numpy(), ref[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_forward(models, arch):
    """A 9-token prefill and 3 decode steps: logits, hidden states and
    every cache leaf against the reference (default capacity); then, at
    an uncapped capacity, prefill + decode against the port's own full
    forward over the same tokens (the encoder output fed to the decode
    steps of the encoder-decoder; a vision model's serving is text-only,
    so its forward, which prepends patches, is no oracle)."""
    jcfg, jp, tcfg, tp = models(arch)
    S = 3
    jb, tb = _batch(tcfg, B, P + S, seed=2)
    enc = (None, None)
    if tcfg.enc_dec:
        enc = (jencoder(jp, jb["enc_feats"], cfg=jcfg, ctx=ModelCtx()),
               tencoder(tp, tb["enc_feats"], cfg=tcfg))
        _close(enc[1].numpy(), enc[0])
    jpf, jdf = _jfns(jcfg)
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jcache_shapes(jcfg, B, ML))
    tc = tserve.zero_caches(tcfg, B, ML, device="cpu")
    # serving is text-only: prefill takes no patches
    head = {k: v[:, :P] if k == "tokens" else v for k, v in jb.items()
            if k != "patch_feats"}
    jl, jc, jh = jpf(jp, head, jc)
    tl, tc, th = prefill(tp, {k: v[:, :P] if k == "tokens" else v
                              for k, v in tb.items()}, tc, cfg=tcfg,
                         return_hidden=True)
    _close(tl.numpy(), jl)
    _close(th.numpy(), jh)
    _trees_close(tc, jc)
    for s in range(S):
        tok = jb["tokens"][:, P + s:P + s + 1]
        pos = jnp.full((B,), P + s, jnp.int32)
        jl, jc, jh = jdf(jp, tok, pos, jc, enc_out=enc[0])
        tl, tc, th = decode_step(tp, torch.from_numpy(np.array(tok)),
                                 torch.from_numpy(np.array(pos)), tc,
                                 cfg=tcfg, enc_out=enc[1],
                                 return_hidden=True)
        _close(tl.numpy(), jl)
        _close(th.numpy(), jh)
        _trees_close(tc, jc)
    if tcfg.frontend == "vision":
        return
    cfg = _capped(tcfg, 64.0)
    full = model_fwd(tp, tb, cfg=cfg)["logits"]
    tc = tserve.zero_caches(cfg, B, ML, device="cpu")
    lg, tc = prefill(tp, {k: v[:, :P] if k == "tokens" else v
                          for k, v in tb.items()}, tc, cfg=cfg)
    steps = [lg]
    for s in range(S - 1):
        lg, tc = decode_step(tp, tb["tokens"][:, P + s:P + s + 1],
                             torch.full((B,), P + s), tc, cfg=cfg,
                             enc_out=enc[1])
        steps.append(lg)
    _close(torch.cat(steps, dim=1).numpy(),
           full[:, P - 1:P + S - 1].numpy())


# ---------------------------------------------------------------------------
# Init tree and the converter's dtypes
# ---------------------------------------------------------------------------

def _bf16(arch):
    return dataclasses.replace(jget_smoke(arch), dtype="bfloat16"), \
        dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("deepseek-v3-671b", "bfloat16"),
                            ("jamba-1.5-large-398b", "bfloat16")])
def test_init_model_tree_shapes_dtypes_follow_reference(arch, dtype):
    """The port's own draw: the reference's tree (the prefix a list),
    shapes and dtypes, the router and ``a_log`` float32 in bf16."""
    jcfg, tcfg = (jget_smoke(arch), get_smoke_config(arch)) \
        if dtype == "float32" else _bf16(arch)
    ref = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    ours = list(_flat(init_model(0, tcfg, device="cpu")))
    ref = sorted(_jflat(ref), key=lambda e: e[0])
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (p, t), (_, s) in zip(ours, ref):
        assert tuple(t.shape) == s.shape, p
        assert str(t.dtype).split(".")[-1] == str(s.dtype), p
    f32 = {p[-1] for p, t in ours if t.dtype == torch.float32}
    if dtype == "bfloat16":
        assert f32 == ({"router"} if tcfg.mamba is None
                       else {"router", "a_log"})


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_params_from_numpy_keeps_each_leafs_dtype(models, arch):
    """A bf16 model's tree in the reference's dtypes (the smoke weights
    rounded to bf16 where ``jax.eval_shape`` of its init says so): the
    float32 leaves (router, ``a_log``) cross as float32 and bit for bit,
    the bf16 ones as bf16."""
    _, jp, _, _ = models(arch)
    jcfg, tcfg = _bf16(arch)
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(lambda a, s: np.asarray(a).astype(s.dtype), jp,
                        shapes)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    ref = sorted(_jflat(tree), key=lambda e: e[0])
    ours = list(_flat(tp))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    seen = set()
    for (p, t), (_, a) in zip(ours, ref):
        assert str(t.dtype).split(".")[-1] == str(a.dtype), p
        assert np.array_equal(t.float().numpy(), a.astype(np.float32)), p
        if t.dtype == torch.float32:
            seen.add(p[-1])
    assert seen == ({"router"} if tcfg.mamba is None
                    else {"router", "a_log"})


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_uncoded_greedy_tokens_equal_reference_loop(models, arch):
    """The reference launcher's loop (an enc-dec fed 0.1 features at
    prefill, no encoder output at decode) against ``generate``."""
    jcfg, jp, tcfg, tp = models(arch)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, size=(B, P))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    if jcfg.enc_dec:
        batch["enc_feats"] = jnp.full((B, jcfg.frontend_len,
                                       jcfg.frontend_dim), 0.1, jnp.float32)
    jc = jserve.zero_caches(jcfg, B, ML)
    pf, df = _jfns(jcfg)
    logits, jc, _ = pf(jp, batch, jc)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    ref = [np.asarray(tok)]
    for i in range(G - 1):
        logits, jc, _ = df(jp, tok, jnp.full((B,), P + i, jnp.int32), jc,
                           enc_out=None)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        ref.append(np.asarray(tok))
    ours, _, _ = tserve.generate(tcfg, tp, torch.from_numpy(toks), G)
    assert np.array_equal(ours, np.concatenate(ref, axis=1))


N_REQ, PROMPT, GEN, SLOTS = 5, 12, 4, 4


def _bridges(arch, **kw):
    kw = dict(arch=arch, smoke=True, masters=1, slots_per_master=SLOTS,
              seed=0, backend="numpy", **kw)
    return JBridge(**kw), CodedServingBridge(device="cpu", **kw)


def _serve_both(jb, tb, vocab):
    ref = jb.serve(jrequests(N_REQ, masters=1, vocab=vocab,
                             prompt_len=PROMPT, gen_len=GEN, seed=0))
    rep = tb.serve(synthetic_requests(N_REQ, masters=1, vocab=vocab,
                                      prompt_len=PROMPT, gen_len=GEN,
                                      seed=0))
    return ref, rep


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_coded_head_bridge_tokens_equal_reference(models, arch):
    """Virtual parity, batched engine, 5 requests over 4 slots (a slot is
    reused: the slot scatter carries the prefix list, the MLA latents and
    the Mamba state)."""
    jcfg, _, _, _ = models(arch)
    jb, tb = _bridges(arch, coding_scope="head", parity_storage="virtual")
    ref, rep = _serve_both(jb, tb, jcfg.vocab)
    assert rep.decode_ok and ref.decode_ok, (rep.max_err, ref.max_err)
    assert rep.tokens == ref.tokens
    assert rep.solve_steps == ref.solve_steps


def test_gemma3_trunk_scope_tokens_equal_reference(models):
    """Sliding windows in the float64 host trunk, on the serial engine:
    tokens and max_err equal the reference bridge's bit for bit."""
    jcfg, _, _, _ = models("gemma3-12b")
    jb, tb = _bridges("gemma3-12b", coding_scope="trunk",
                      execution="serial")
    ref, rep = _serve_both(jb, tb, jcfg.vocab)
    assert rep.decode_ok and rep.tokens == ref.tokens
    assert rep.max_err == ref.max_err


def test_enc_dec_bridge_raises_as_reference(models):
    models("seamless-m4t-large-v2")
    for bridge in _bridges("seamless-m4t-large-v2", coding_scope="head"):
        with pytest.raises(NotImplementedError):
            bridge._setup_model(PROMPT + GEN + 8)
