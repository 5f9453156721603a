"""The port's RWKV-6 path against the reference's, on the CPU.

The WKV plain versions (``repro_torch.kernels.ref``) against
``repro.models.rwkv.wkv6_chunked``, ``repro.kernels.ref.wkv6_chunk_ref``
and the Pallas kernel in interpret mode; the sequential oracle against a
float64 numpy recurrence at strong decays (what ``chip_smoke.py`` holds
the CUDA kernel to there); the mixer, the model and coded serving on the
``rwkv6-smoke`` config (d_model 64, 2 layers, vocab 512, float32) with the
reference's parameters carried across.  Inputs come from seeded numpy
generators.

Tolerances: 1e-5 where both sides compute the same formula in float32
(only the order of float32 sums differs), 1e-4 relative for the model's
logits (as ``test_torch_models.py``), and the reference's own 3e-3 for the
interpret-mode Pallas kernel.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
import repro_torch.launch.serve as tserve  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import model_fwd as jfwd  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.serve_coded import CodedServingBridge as JBridge  # noqa: E402
from repro.serve_coded import synthetic_requests as jrequests  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import decode_step, model_fwd, prefill  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.serve_coded import CodedServingBridge  # noqa: E402
from repro_torch.serve_coded import synthetic_requests  # noqa: E402

ARCH = "rwkv6-7b"
SAME = 1e-5          # one formula in float32, sums in another order
TOL = 1e-4           # model logits, relative (as test_torch_models.py)


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
    """The reference's smoke model and the same parameters in the port,
    also seeded into the port's model memo so its bridge serves them."""
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


def _wkv_inputs(shape_k, V, seed, lo=0.85, hi=0.999):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=shape_k).astype(np.float32)
    k = rng.normal(size=shape_k).astype(np.float32)
    v = rng.normal(size=shape_k[:-1] + (V,)).astype(np.float32)
    w = rng.uniform(lo, hi, size=shape_k).astype(np.float32)
    return r, k, v, w


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * (1.0 + np.abs(b).max()), err


# ---------------------------------------------------------------------------
# 1-3. The WKV plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,chunk,H", [(64, 16, 2), (80, 32, 3), (37, 16, 1),
                                       (5, 64, 2)])
def test_chunked_ref_matches_model_wkv(T, chunk, H):
    """Output and final state of the model's chunked WKV, with a per-head
    u, including a T that is not a multiple of the chunk."""
    B, K, V = 2, 16, 16
    r, k, v, w = _wkv_inputs((B, H, T, K), V, seed=T + chunk + H)
    u = np.random.default_rng(T).normal(size=(H, K)).astype(np.float32)
    jo, js = jrwkv.wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                chunk=chunk)
    to, ts = tref.wkv6_chunked_ref(*_t(r, k, v, w, u), chunk=chunk)
    _close(to.numpy(), jo, SAME)
    _close(ts.numpy(), js, SAME)


def test_chunk_ref_matches_reference_oracle():
    r, k, v, w = _wkv_inputs((48, 16), 24, seed=3)
    u = np.random.default_rng(4).normal(size=(16,)).astype(np.float32)
    want = jref.wkv6_chunk_ref(*map(jnp.asarray, (r, k, v, w, u)))
    _close(tref.wkv6_chunk_ref(*_t(r, k, v, w, u)).numpy(), want, SAME)
    # the output takes v's dtype, as the reference's does
    bf = [t.to(torch.bfloat16) for t in _t(r, k, v, w)]
    assert tref.wkv6_chunk_ref(*bf, _t(u)[0]).dtype == torch.bfloat16


@pytest.mark.parametrize("T,K,V,chunk", [(64, 8, 8, 16), (80, 16, 24, 32),
                                         (128, 32, 32, 64)])
def test_ops_wkv6_matches_pallas_interpret(T, K, V, chunk):
    """The reference's sweep (``tests/test_kernels.py``) with a shared u:
    the port's ``ops.wkv6`` against the interpret-mode Pallas kernel at
    its 3e-3 and against the sequential oracle at 1e-5."""
    r, k, v, w = _wkv_inputs((2, T, K), V, seed=T + K)
    u = np.random.default_rng(K).normal(size=(K,)).astype(np.float32)
    ours = tops.wkv6(*_t(r, k, v, w, u), chunk=chunk).numpy()
    theirs = np.asarray(jops.wkv6(*map(jnp.asarray, (r, k, v, w, u)),
                                  chunk=chunk, interpret=True))
    np.testing.assert_allclose(ours, theirs, rtol=3e-3, atol=3e-3)
    _close(ours, tref.wkv6_chunk_ref(*_t(r, k, v, w, u)).numpy(), SAME)


def _wkv_f64(r, k, v, w, u, S=None):
    """float64 numpy recurrence over (..., T, ·); returns (out, state)."""
    r, k, v, w = (x.astype(np.float64) for x in (r, k, v, w))
    S = np.zeros(r.shape[:-2] + (r.shape[-1], v.shape[-1])) \
        if S is None else S.astype(np.float64)
    out = np.empty(v.shape)
    for t in range(r.shape[-2]):
        kv = k[..., t, :, None] * v[..., t, None, :]
        out[..., t, :] = ((S + u[..., :, None] * kv)
                          * r[..., t, :, None]).sum(-2)
        S = w[..., t, :, None] * S + kv
    return out, S


@pytest.mark.parametrize("lo,hi,chunked_finite", [(0.05, 0.999, True),
                                                   (0.05, 0.25, False)])
def test_sequential_oracle_holds_at_strong_decays(lo, hi, chunked_finite):
    """Strong decays: the sequential oracle stays at float32 accuracy
    against float64.  The chunked form's exp(-cumsum(log w)) stays finite
    at chunk 64 while a chunk's mean log w is above about -1.39: so for
    w ∈ [0.05, 0.999] (mean log w ≈ -0.84), not for w ∈ [0.05, 0.25]."""
    H, T, K = 2, 256, 16
    r, k, v, w = _wkv_inputs((1, H, T, K), K, seed=9, lo=lo, hi=hi)
    u = np.random.default_rng(9).normal(size=(H, K)).astype(np.float32)
    want, _ = _wkv_f64(r, k, v, w, u[None])
    got = tref.wkv6_chunk_ref(*_t(r, k, v, w, u)).numpy()
    _close(got, want, SAME)
    chunked, _ = tref.wkv6_chunked_ref(*_t(r, k, v, w, u), chunk=64)
    assert np.isfinite(chunked.numpy()).all() == chunked_finite


@pytest.mark.parametrize("T2", [1, 19])
def test_initial_state_continues_the_sequence(T2):
    """Running T1 steps, then T2 more from the carried state, equals the
    sequential oracle over all T1 + T2 steps (T2 = 1 is the decode
    branch's hand-off)."""
    B, H, T1, K = 2, 2, 23, 16
    r, k, v, w = _wkv_inputs((B, H, T1 + T2, K), K, seed=T2)
    u = np.random.default_rng(T2 + 1).normal(size=(H, K)).astype(np.float32)
    tr, tk, tv, tw, tu = _t(r, k, v, w, u)
    want = tref.wkv6_chunk_ref(tr, tk, tv, tw, tu)
    o1, s1 = tops.wkv6_heads(tr[:, :, :T1], tk[:, :, :T1], tv[:, :, :T1],
                             tw[:, :, :T1], tu)
    o2, s2 = tops.wkv6_heads(tr[:, :, T1:], tk[:, :, T1:], tv[:, :, T1:],
                             tw[:, :, T1:], tu, s1)
    _close(torch.cat([o1, o2], dim=2).numpy(), want.numpy(), SAME)
    _, s_all = _wkv_f64(r, k, v, w, u)
    _close(s2.numpy(), s_all, SAME)


@pytest.mark.parametrize("T,chunk,H", [(64, 16, 2), (37, 16, 1), (40, 8, 2)])
def test_subchunk_ref_matches_model_wkv(T, chunk, H):
    """The kernel's factorisation (``ref.wkv6_subchunk_ref``: chunks of
    ``chunk`` steps, pairs through a reference step at each level) against
    the model's chunked WKV at ordinary decays: output and final state,
    with a ragged last chunk."""
    B, K, V = 2, 16, 16
    r, k, v, w = _wkv_inputs((B, H, T, K), V, seed=T + chunk + H)
    u = np.random.default_rng(T + 1).normal(size=(H, K)).astype(np.float32)
    jo, js = jrwkv.wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)))
    to, ts = tref.wkv6_subchunk_ref(*_t(r, k, v, w, u), chunk=chunk)
    _close(to.numpy(), jo, SAME)
    _close(ts.numpy(), js, SAME)


@pytest.mark.parametrize("lo,hi,zero_every", [(0.05, 0.25, 0),
                                              (0.0, 1e-11, 3),
                                              (0.0, 0.0, 0)])
def test_subchunk_ref_holds_at_strong_decays(lo, hi, zero_every):
    """Strong decays, decays below the 1e-12 clamp and exact zeros, from an
    initial state: the kernel's factorisation stays at float32 accuracy
    against a float64 recurrence (every factor is a product of decays, each
    <= 1), at decays where the model's chunked form overflows."""
    H, T, K = 2, 96, 16
    r, k, v, w = _wkv_inputs((1, H, T, K), K, seed=7, lo=lo, hi=hi)
    if zero_every:
        w[..., ::zero_every, :] = 0.0
    rng = np.random.default_rng(8)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s0 = rng.normal(size=(1, H, K, K)).astype(np.float32)
    want, s_want = _wkv_f64(r, k, v, w, u[None], s0)
    got, s_got = tref.wkv6_subchunk_ref(*_t(r, k, v, w, u, s0))
    _close(got.numpy(), want, SAME)
    _close(s_got.numpy(), s_want, SAME)


# ---------------------------------------------------------------------------
# 4. The mixers on all three branches
# ---------------------------------------------------------------------------

def _layer_params(jparams, tparams, layer=0):
    jl = jax.tree.map(lambda a: a[layer], jparams["blocks"]["layer0"])
    tl = {k: {n: t[layer] for n, t in v.items()}
          for k, v in tparams["blocks"]["layer0"].items()
          if isinstance(v, dict)}
    return jl, tl


def _zero_cache(cfg, B, jnp_side):
    d, hs = cfg.d_model, cfg.rwkv_head_size
    shapes = {"wkv": (B, d // hs, hs, hs), "shift_t": (B, d),
              "shift_c": (B, d)}
    if jnp_side:
        return {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    return {k: torch.zeros(s) for k, s in shapes.items()}


def _cache_close(tc, jc):
    assert tc.keys() == jc.keys()
    for name in tc:
        _close(tc[name].numpy(), jc[name], SAME)


def test_mixers_match_reference_on_every_branch(pair):
    jcfg, jp, tcfg, tp = pair
    jl, tl = _layer_params(jp, tp, layer=1)
    B, T = 2, 11
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, T, tcfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    # no cache
    jo, _ = jrwkv.apply_rwkv_tmix(jl["mixer"], jnp.asarray(x), cfg=jcfg)
    to, tc = trwkv.apply_rwkv_tmix(tl["mixer"], torch.from_numpy(x),
                                   cfg=tcfg)
    assert tc is None
    _close(to.numpy(), jo, SAME)
    jo, _ = jrwkv.apply_rwkv_cmix(jl["ffn"], jnp.asarray(x))
    to, _ = trwkv.apply_rwkv_cmix(tl["ffn"], torch.from_numpy(x))
    _close(to.numpy(), jo, SAME)
    # prefill with a zero cache, then one-token decode, tmix then cmix
    jc, tc = _zero_cache(jcfg, B, True), _zero_cache(tcfg, B, False)
    for xs in (x, x1):
        jo, jc = jrwkv.apply_rwkv_tmix(jl["mixer"], jnp.asarray(xs),
                                       cfg=jcfg, cache=jc)
        to, tc = trwkv.apply_rwkv_tmix(tl["mixer"], torch.from_numpy(xs),
                                       cfg=tcfg, cache=tc)
        _close(to.numpy(), jo, SAME)
        _cache_close(tc, jc)
        jo, jc = jrwkv.apply_rwkv_cmix(jl["ffn"], jnp.asarray(xs), cache=jc)
        to, tc = trwkv.apply_rwkv_cmix(tl["ffn"], torch.from_numpy(xs),
                                       cache=tc)
        _close(to.numpy(), jo, SAME)
        _cache_close(tc, jc)


# ---------------------------------------------------------------------------
# 5. The model
# ---------------------------------------------------------------------------

def _tokens(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T))


def test_model_fwd_logits_match(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(2, 70, jcfg.vocab)          # past one 64-step chunk
    ref = jfwd(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
               cfg=jcfg)["logits"]
    ours = model_fwd(tp, {"tokens": torch.from_numpy(toks)}, cfg=tcfg)
    _close(ours["logits"].numpy(), ref, TOL)


def test_prefill_and_decode_match_reference_and_full_forward(pair):
    """The port's twin of the reference's
    ``test_prefill_then_decode_matches_full_forward`` (its bound is 2e-2;
    float32 gives 1e-4 here), plus the caches against the reference's."""
    jcfg, jp, tcfg, tp = pair
    B, T = 2, 12
    toks = _tokens(B, T + 1, jcfg.vocab, seed=1)
    full = model_fwd(tp, {"tokens": torch.from_numpy(toks)},
                     cfg=tcfg)["logits"][:, -1]
    jc = jserve.zero_caches(jcfg, B, 32)
    tc = tserve.zero_caches(tcfg, B, 32, device="cpu")
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :T], jnp.int32)},
                      jc, cfg=jcfg)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks[:, :T])}, tc,
                     cfg=tcfg)
    _close(tl.numpy(), jl, TOL)
    pos = np.full((B,), T)
    jl, jc = jdecode(jp, jnp.asarray(toks[:, T:], jnp.int32),
                     jnp.asarray(pos, jnp.int32), jc, cfg=jcfg)
    tl, tc = decode_step(tp, torch.from_numpy(toks[:, T:]),
                         torch.from_numpy(pos), tc, cfg=tcfg)
    _close(tl.numpy(), jl, TOL)
    _close(tl[:, 0].numpy(), full.numpy(), TOL)
    _cache_close(tc["blocks"]["layer0"]["mixer"],
                 jc["blocks"]["layer0"]["mixer"])


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


def test_init_model_tree_follows_reference(pair):
    """The port draws its own values, with the reference's tree, shapes,
    dtypes and scales."""
    jcfg, jp, tcfg, _ = pair
    from repro_torch.models import init_model
    own = init_model(0, tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_own = len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: 0, own)))
    assert n_own == len(flat_j)
    for path, leaf in flat_j:
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        assert abs(float(node.float().std()) - float(jnp.std(leaf))) \
            <= 0.25 * float(jnp.std(leaf)) + 1e-6, path


# ---------------------------------------------------------------------------
# 6. Coded serving of the head
# ---------------------------------------------------------------------------

N_REQ, PROMPT, GEN, SLOTS = 6, 16, 5, 4


def _alone(tcfg, tp, req):
    """One request's own batch-1 greedy generation."""
    toks, _, _ = tserve.generate(
        tcfg, tp, torch.from_numpy(np.asarray(req.prompt, np.int64)[None]),
        req.gen_len)
    return [int(t) for t in toks[0]]


@pytest.mark.parametrize("spd", [1, 2])
def test_coded_bridge_tokens_equal_reference_and_own_generation(pair, spd):
    """6 requests over 4 slots (slots are reused, so the slot scatter
    carries the recurrent state): the port's bridge gives the reference
    bridge's tokens and each request's own generation, decode_ok."""
    jcfg, jp, tcfg, tp = pair
    kw = dict(arch=ARCH, smoke=True, masters=1, slots_per_master=SLOTS,
              coding_scope="head", steps_per_dispatch=spd, seed=0,
              backend="numpy")
    jb = JBridge(**kw)
    ref = jb.serve(jrequests(N_REQ, masters=1, vocab=jcfg.vocab,
                             prompt_len=PROMPT, gen_len=GEN, seed=0))
    tb = CodedServingBridge(device="cpu", **kw)
    reqs = synthetic_requests(N_REQ, masters=1, vocab=tcfg.vocab,
                              prompt_len=PROMPT, gen_len=GEN, seed=0)
    rep = tb.serve(reqs)
    assert rep.decode_ok, rep.max_err
    assert rep.tokens == ref.tokens
    for req in reqs:
        assert list(rep.tokens[req.rid]) == _alone(tcfg, tp, req), req.rid
