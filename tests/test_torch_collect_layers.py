"""``collect_layers`` of the port's ``prefill`` and ``decode_step``: every
layer's post-residual state (the prefix layers, then the repeats, before
the final norm), held against the reference's list at the model tests'
tolerance, and the trunk scope's float64 ``HostTrunk`` held against it
layer by layer (the reference's ``tests/test_coded_trunk.py`` check, on
the port)."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch.serve import zero_caches as jzero_caches  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import zero_caches  # noqa: E402
from repro_torch.models import decode_step, init_model, prefill  # noqa: E402

TOL = 1e-4            # x (1 + max |state|), tests/test_torch_archs.py's
B, P, ML = 2, 9, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * (1.0 + np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _jfns(jcfg):
    return (jax.jit(functools.partial(jprefill, cfg=jcfg,
                                      collect_layers=True)),
            jax.jit(functools.partial(jdecode, cfg=jcfg,
                                      collect_layers=True)))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_v3_671b"])
def test_collect_layers_matches_reference(arch):
    """llama (repeats only) and deepseek-v3 (a prefix layer, then MLA + MoE
    repeats): the prefill's and a decode step's per-layer states."""
    tcfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    tp = init_model(0, tcfg, device="cpu")
    jp = _to_jax(tp)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tcfg.vocab, size=(B, P + 1))
    jpf, jdc = _jfns(jcfg)
    jl, jc, jlayers = jpf(jp, {"tokens": jnp.asarray(toks[:, :P],
                                                     jnp.int32)},
                          jzero_caches(jcfg, B, ML))
    with torch.no_grad():
        tl, tc, tlayers = prefill(
            tp, {"tokens": torch.from_numpy(toks[:, :P])},
            zero_caches(tcfg, B, ML, device="cpu"), cfg=tcfg,
            collect_layers=True)
    n = len(tcfg.prefix) + tcfg.n_repeats * len(tcfg.block)
    assert len(tlayers) == len(jlayers) == n
    assert bool(tcfg.prefix) == (arch == "deepseek_v3_671b")
    for t, j in zip(tlayers, jlayers):
        _close(t, j)
    _close(tl, jl)
    pos = np.full((B,), P)
    jl, _, jlayers = jdc(jp, jnp.asarray(toks[:, P:], jnp.int32),
                         jnp.asarray(pos, jnp.int32), jc)
    with torch.no_grad():
        tl, _, tlayers = decode_step(
            tp, torch.from_numpy(toks[:, P:]), torch.from_numpy(pos), tc,
            cfg=tcfg, collect_layers=True)
    assert len(tlayers) == len(jlayers) == n
    for t, j in zip(tlayers, jlayers):
        assert t.shape == (B, 1, tcfg.d_model)
        _close(t, j)
    _close(tl, jl)


def test_collect_layers_leaves_the_outputs_unchanged():
    cfg = get_smoke_config("llama3_2_1b")
    p = init_model(0, cfg, device="cpu")
    toks = torch.arange(2 * P).reshape(2, P) % cfg.vocab
    with torch.no_grad():
        a = prefill(p, {"tokens": toks}, zero_caches(cfg, 2, ML, "cpu"),
                    cfg=cfg, return_hidden=True)
        b = prefill(p, {"tokens": toks}, zero_caches(cfg, 2, ML, "cpu"),
                    cfg=cfg, return_hidden=True, collect_layers=True)
    assert len(b) == 4 and torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    # the last layer's state, normed, is the returned hidden state
    from repro_torch.models import layers as ly
    last = ly.rms_norm(b[3][-1][:, -1:], p["final_norm"], cfg.norm_eps)
    assert torch.equal(last, b[2])


def test_host_trunk_tracks_the_port_layer_by_layer():
    from repro_torch.launch.serve import build_model, head_matrix
    from repro_torch.serve_coded import HostTrunk, trunk_matmul_keys
    cfg, params = build_model("llama3.2-1b", smoke=True, seed=0,
                              device="cpu")
    runner = HostTrunk(cfg, params, head_matrix(cfg, params))
    rng = np.random.default_rng(3)
    n = 12
    prompt = rng.integers(0, cfg.vocab, size=(1, n)).astype(np.int64)
    with torch.no_grad():
        logits, _, hid, layers = prefill(
            params, {"tokens": torch.from_numpy(prompt)},
            zero_caches(cfg, 1, n + 2, device="cpu"), cfg=cfg,
            return_hidden=True, collect_layers=True)
    assert len(layers) == cfg.n_repeats * len(cfg.block)
    caches = runner.zero_caches(1, n + 2)
    mm_log = {}

    def probe(key, X):
        out = runner.local_matmul(key, X)
        mm_log[key] = out
        return out

    host_layers: list = []
    runner.forward(prompt, np.arange(n)[None], np.array([0]), caches, probe,
                   collect=host_layers)
    # every trunk matmul was routed through the hook exactly once
    assert set(mm_log) == set(trunk_matmul_keys(cfg, "trunk"))
    # layer by layer: the float64 host re-execution tracks the float32
    # model to float32 precision
    assert len(host_layers) == len(layers)
    for host_h, h in zip(host_layers, layers):
        np.testing.assert_allclose(host_h, h.double().numpy(), atol=5e-5)
