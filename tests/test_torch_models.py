"""The port's dense decoder against the reference's, on the same
parameters (``repro_torch.convert.params_from_numpy``), llama3.2-smoke in
float32: logits, prefill/decode hidden states and KV caches at 1e-4, and
equal greedy tokens from the uncoded serve loops."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import model_fwd as jfwd  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import decode_step, model_fwd, prefill  # noqa: E402

ARCH = "llama3.2-1b"
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the driver runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, jparams = jserve.build_model(ARCH, smoke=True, seed=0)
    tcfg = get_smoke_config(ARCH)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * (1.0 + np.abs(b).max())


def test_model_fwd_logits_match(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(2, 13, jcfg.vocab)
    ref = jfwd(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
               cfg=jcfg)["logits"]
    ours = model_fwd(tp, {"tokens": torch.from_numpy(toks)}, cfg=tcfg)
    _close(ours["logits"].numpy(), ref)


def test_prefill_and_decode_hidden_and_caches_match(pair):
    jcfg, jp, tcfg, tp = pair
    B, P, ML = 2, 9, 20
    toks = _tokens(B, P, jcfg.vocab, seed=1)
    jc = jserve.zero_caches(jcfg, B, ML)
    tc = tserve.zero_caches(tcfg, B, ML, device="cpu")
    jl, jc, jh = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                          cfg=jcfg, return_hidden=True)
    tl, tc, th = prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                         cfg=tcfg, return_hidden=True)
    _close(tl.numpy(), jl)
    _close(th.numpy(), jh)
    nxt = np.array([[5], [77]])
    pos = np.array([P, P])
    jl, jc, jh = jdecode(jp, jnp.asarray(nxt, jnp.int32),
                         jnp.asarray(pos, jnp.int32), jc, cfg=jcfg,
                         return_hidden=True)
    tl, tc, th = decode_step(tp, torch.from_numpy(nxt), torch.from_numpy(pos),
                             tc, cfg=tcfg, return_hidden=True)
    _close(tl.numpy(), jl)
    _close(th.numpy(), jh)
    for name in ("k", "v"):
        _close(tc["blocks"]["layer0"]["mixer"][name].numpy(),
               jc["blocks"]["layer0"]["mixer"][name])
    assert np.array_equal(tc["blocks"]["layer0"]["mixer"]["len"].numpy(),
                          np.asarray(jc["blocks"]["layer0"]["mixer"]["len"]))


def test_uncoded_greedy_tokens_equal(pair):
    jcfg, jp, tcfg, tp = pair
    B, P, G = 3, 10, 6
    toks = _tokens(B, P, jcfg.vocab, seed=2)
    jc = jserve.zero_caches(jcfg, B, P + G + 8)
    pf, df = jserve.serving_fns(jcfg)
    logits, jc = pf(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    ref = [np.asarray(tok)]
    for i in range(G - 1):
        logits, jc = df(jp, tok, jnp.full((B,), P + i, jnp.int32), jc)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        ref.append(np.asarray(tok))
    ours, _, _ = tserve.generate(tcfg, tp, torch.from_numpy(toks), G)
    assert np.array_equal(ours, np.concatenate(ref, axis=1))


def test_init_model_shapes_dtypes_and_scales_follow_reference(pair):
    """The port draws its own values, with the reference's tree, shapes,
    dtypes and scales."""
    jcfg, jp, tcfg, _ = pair
    _, own = tserve.build_model(ARCH, smoke=True, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        assert abs(float(node.float().std()) - float(jnp.std(leaf))) \
            <= 0.25 * float(jnp.std(leaf)) + 1e-6, path
