"""The port's remaining mixers against the reference's, layer by layer on
the CPU: windowed GQA (a ring smaller than the prompt), MLA (expanded
prefill, absorbed decode), cross-attention, MoE (capacity with and
without drops, the dispatch tables) and Mamba (full sequence, prefill,
decode).  Parameters are drawn by the reference's layer inits at the smoke
configs (float32) and carried across with ``params_from_numpy``; inputs come from seeded numpy
generators.  Tolerance: 1e-4 × (1 + max |ref|), as
``test_torch_models.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once
    and torch's CPU thread pools thrash when oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(arch, init, seed=0):
    """One layer's parameters drawn by the reference's ``init`` at the
    arch's smoke config, and the same values in the port."""
    from repro.configs import get_smoke_config as jget_smoke_config
    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    jl = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tl = params_from_numpy(jax.tree.map(np.asarray, jl), tcfg, device="cpu")
    return jcfg, jl, tcfg, tl


def _jit(fn, **static):
    """The reference function jitted over its arrays (eager JAX compiles
    every primitive on its own, far slower at these sizes)."""
    return jax.jit(functools.partial(fn, **static))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * (1.0 + np.abs(b).max())


def _zeros(spec_tree, jnp_side):
    if jnp_side:
        return {k: jnp.zeros(s.shape, s.dtype) for k, s in spec_tree.items()}
    return {k: torch.zeros(s, dtype=d) for k, (s, d) in spec_tree.items()}


def _caches_close(tc, jc):
    assert tc.keys() == jc.keys()
    for k in tc:
        if k == "len":
            assert np.array_equal(tc[k].numpy(), np.asarray(jc[k])), k
        else:
            _close(tc[k].numpy(), jc[k])


def _positions(B, start, T):
    p = np.broadcast_to(np.arange(start, start + T), (B, T))
    return jnp.asarray(p, jnp.int32), torch.from_numpy(p.copy())


# ---------------------------------------------------------------------------
# Attention: sliding-window ring, MLA, cross
# ---------------------------------------------------------------------------

def _run_cached(japply, tapply, jcache, tcache, B, P, d, steps=3):
    """A prefill of P tokens, then ``steps`` one-token decodes, both
    sides; outputs and caches compared after each call."""
    for i, (start, T) in enumerate([(0, P)] + [(P + s, 1)
                                               for s in range(steps)]):
        x = _x((B, T, d), 10 + i)
        jpos, tpos = _positions(B, start, T)
        jo, jcache = japply(jnp.asarray(x), jpos, jcache)
        to, tcache = tapply(torch.from_numpy(x), tpos, tcache)
        _close(to.numpy(), jo)
        _caches_close(tcache, jcache)


def test_windowed_gqa_ring_matches_reference():
    """gemma3-smoke's local layer (window 8): the full sequence, then a
    13-token prompt into an 8-slot ring (the tail kept, rolled) and three
    decode steps around the ring."""
    jcfg, jl, tcfg, tl = _layer("gemma3-12b", jattn.init_gqa)
    window = jcfg.block[0].sliding_window
    base = jcfg.rope_base_local
    B, P, ML, d = 2, 13, 20, jcfg.d_model
    x = _x((B, 17, d), 1)
    japply = _jit(jattn.apply_gqa, cfg=jcfg, window=window, rope_base=base)
    jo, _ = japply(jl, jnp.asarray(x))
    to, tc = tattn.apply_gqa(tl, torch.from_numpy(x), cfg=tcfg,
                             window=window, rope_base=base)
    assert tc is None
    _close(to.numpy(), jo)
    jspec = jattn.gqa_cache_spec(jcfg, B, ML, window, jnp.float32)
    tspec = tattn.gqa_cache_spec(tcfg, B, ML, window, torch.float32)
    assert tspec["k"][0] == jspec["k"].shape == (B, window, 2, 16)
    _run_cached(
        lambda x, p, c: japply(jl, x, positions=p, cache=c),
        lambda x, p, c: tattn.apply_gqa(tl, x, cfg=tcfg, window=window,
                                        rope_base=base, positions=p,
                                        cache=c),
        _zeros(jspec, True), _zeros(tspec, False), B, P, d)


def test_mla_expanded_prefill_and_absorbed_decode_match_reference():
    jcfg, jl, tcfg, tl = _layer("deepseek-v3-671b", jattn.init_mla)
    B, P, ML, d = 2, 11, 20, jcfg.d_model
    x = _x((B, 14, d), 2)
    japply = _jit(jattn.apply_mla, cfg=jcfg)
    jo, _ = japply(jl, jnp.asarray(x))
    to, tc = tattn.apply_mla(tl, torch.from_numpy(x), cfg=tcfg)
    assert tc is None
    _close(to.numpy(), jo)
    jspec = jattn.mla_cache_spec(jcfg, B, ML, jnp.float32)
    tspec = tattn.mla_cache_spec(tcfg, B, ML, torch.float32)
    assert {k: s for k, (s, _) in tspec.items()} == \
        {k: v.shape for k, v in jspec.items()}
    _run_cached(
        lambda x, p, c: japply(jl, x, positions=p, cache=c),
        lambda x, p, c: tattn.apply_mla(tl, x, cfg=tcfg, positions=p,
                                        cache=c),
        _zeros(jspec, True), _zeros(tspec, False), B, P, d)


def test_cross_attention_matches_reference():
    jcfg, jl, tcfg, tl = _layer("seamless-m4t-large-v2",
                                jattn.init_cross)
    x, enc = _x((2, 5, jcfg.d_model), 3), _x((2, 24, jcfg.d_model), 4)
    jo = _jit(jattn.apply_cross, cfg=jcfg)(jl, jnp.asarray(x),
                                           jnp.asarray(enc))
    to = tattn.apply_cross(tl, torch.from_numpy(x), torch.from_numpy(enc),
                           cfg=tcfg)
    _close(to.numpy(), jo)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _kept_choices(probs, m, cap):
    """(token, expert) choices the top-k makes, and how many survive the
    experts' capacity."""
    idx, w = jmoe._dispatch(jnp.asarray(probs), m.top_k, cap)
    return probs.shape[0] * m.top_k, int((np.asarray(w) > 0).sum())


@pytest.mark.parametrize("arch,n_tok,drops", [
    ("deepseek-v3-671b", 6, False),      # capacity = every token
    ("deepseek-v3-671b", 96, True),      # shared experts on top
    ("dbrx-132b", 80, True),
])
def test_moe_matches_reference_with_and_without_drops(arch, n_tok, drops):
    jcfg, jl, tcfg, tl = _layer(arch, jmoe.init_moe)
    m = jcfg.moe
    # tokens near one direction crowd the same experts: with drops, some
    # expert is asked for more tokens than its capacity
    x = _x((2, n_tok // 2, jcfg.d_model), 5) * (0.3 if drops else 1.0) \
        + (_x((1, 1, jcfg.d_model), 7) if drops else 0.0)
    xt = x.reshape(-1, jcfg.d_model)
    probs = np.array(jax.nn.softmax(jnp.asarray(xt) @ jl["router"], -1))
    cap = jmoe.moe_capacity(m, n_tok)
    made, kept = _kept_choices(probs, m, cap)
    assert (kept < made) == drops, (made, kept, cap)
    # the dispatch tables: equal weights, equal tokens where a slot holds
    # one (the order of the zero-weight slots is free)
    jidx, jw = jmoe._dispatch(jnp.asarray(probs), m.top_k, cap)
    tidx, tw = tmoe._dispatch(torch.from_numpy(probs), m.top_k, cap)
    jidx, jw = np.asarray(jidx), np.asarray(jw)
    assert np.array_equal(tw.numpy(), jw)
    held = jw > 0
    assert np.array_equal(tidx.numpy()[held], jidx[held])
    jo = _jit(jmoe.apply_moe, cfg=jcfg)(jl, jnp.asarray(x))
    to = tmoe.apply_moe(tl, torch.from_numpy(x), cfg=tcfg)
    _close(to.numpy(), jo)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_moe_capacity_equals_reference(arch):
    m = get_smoke_config(arch).moe
    full = dataclasses.replace(m, capacity_factor=64.0)
    for cfg in (m, full):
        ours = [tmoe.moe_capacity(cfg, n) for n in range(1, 600)]
        ref = [jmoe.moe_capacity(cfg, n) for n in range(1, 600)]
        assert ours == ref


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def test_mamba_sequence_prefill_and_decode_match_reference():
    jcfg, jl, tcfg, tl = _layer("jamba-1.5-large-398b", jssm.init_mamba)
    assert tl["a_log"].dtype == torch.float32
    B, P, d = 2, 9, jcfg.d_model
    x = _x((B, 13, d), 6)
    japply = _jit(jssm.apply_mamba, cfg=jcfg)
    jo, _ = japply(jl, jnp.asarray(x))
    to, tc = tssm.apply_mamba(tl, torch.from_numpy(x), cfg=tcfg)
    assert tc is None
    _close(to.numpy(), jo)
    jspec = jssm.mamba_cache_spec(jcfg, B, jnp.float32)
    tspec = tssm.mamba_cache_spec(tcfg, B, torch.float32)
    _run_cached(
        lambda x, p, c: japply(jl, x, cache=c),
        lambda x, p, c: tssm.apply_mamba(tl, x, cfg=tcfg, cache=c),
        _zeros(jspec, True), _zeros(tspec, False), B, P, d)
