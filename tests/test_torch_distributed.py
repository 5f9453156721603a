"""The port's sharded forward on a 2 x 2 gloo group (("data" 2, "model"
2), four CPU processes started once for the module): the mesh layer's
parameter placements, the vocab-sharded embedding, tensor parallelism
through DTensor, the MoE's expert-parallel bodies and the WKV under
``local_map``.

Each case (a config and a path) holds the group's logits against the
single-device port and the reference's single-device ``model_fwd`` on the
same parameters (the reference's smoke init, carried over with
``params_from_numpy``), at the reference's own sharded-test tolerance of
5e-3 x max |logit| (``tests/test_distribution.py``, which fails on this
jax and is no oracle); checks that every leaf the rules shard is held by
each rank only in its shard (by bytes), that two same-seed forwards are
bit-equal, and that prefill and a B = 1 decode step agree with the
single-device port; and asserts which expert-parallel body ran:
``ep_moe`` for the forward and prefill, ``ep_small`` for the B = 1 decode,
``ep_full_body`` under ``ep_full`` (there also once with float8 dispatch
payloads, against the single-device forward whose expert inputs are
rounded to float8 the same way).  One training step of llama3.2-1b in
float32 through the sharded embedding holds its loss and every gradient
leaf to the single-device port's.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import model_fwd as jfwd  # noqa: E402

HERE = Path(__file__).resolve().parent
ARCHS = ("llama3_2_1b", "dbrx_132b", "rwkv6_7b", "jamba_1_5_large_398b")
CASES = [(a, False) for a in ARCHS] + [("dbrx_132b", True),
                                       ("jamba_1_5_large_398b", True)]
WORLD = 4
B, T = 4, 16
TOL = 5e-3            # x max |logit|, the reference's sharded test's


def _jcfg(arch):
    cfg = jsmoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the four ranks once; (the ranks' results, the reference's
    logits per arch)."""
    work = tmp_path_factory.mktemp("gloo2x2")
    job, ref = [], {}
    for arch in ARCHS:
        cfg = _jcfg(arch)
        params = jinit(jax.random.PRNGKey(0), cfg)
        tokens = np.arange(B * T).reshape(B, T) % cfg.vocab
        ref[arch] = np.asarray(jax.jit(
            lambda p, t: jfwd(p, {"tokens": t}, cfg=cfg)["logits"])(
                params, jnp.asarray(tokens, jnp.int32)), np.float64)
        job.append((arch, jax.tree.map(np.asarray, params),
                    {"tokens": tokens.astype(np.int64)}))
    (work / "job.pkl").write_bytes(pickle.dumps(job))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_dist_worker.py"), str(r),
         str(WORLD), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    return torch.load(work / "result.pt"), ref


def _rel(a, b, scale) -> float:
    return float((a.double() - torch.as_tensor(b).double()).abs().max()) \
        / scale


@pytest.mark.parametrize("arch,ep_full", CASES,
                         ids=[f"{a}-{'ep_full' if e else 'tp'}"
                              for a, e in CASES])
def test_sharded_matches_single_device_and_reference(group, arch, ep_full):
    res, ref = group
    r = res[(arch, ep_full)]
    scale = float(np.abs(ref[arch]).max())
    err_port = _rel(r["sharded"], r["single"], scale)
    err_ref = _rel(r["sharded"], ref[arch], scale)
    print(f"{arch} {'ep_full' if ep_full else 'tp'}: sharded vs port "
          f"{err_port:.3e}, vs reference {err_ref:.3e} (x max |logit| "
          f"{scale:.3f})")
    assert err_port <= TOL and err_ref <= TOL
    assert torch.equal(r["sharded"], r["again"])       # same seed, same bits
    if ep_full:
        # float8 dispatch payloads: against the single-device forward with
        # the expert inputs rounded the same way
        fp8, want = r["fp8"]
        err_fp8 = _rel(fp8, want, scale)
        print(f"  a2a_fp8: vs port with rounded expert inputs {err_fp8:.3e}"
              f" (vs port {_rel(fp8, r['single'], scale):.3e})")
        assert err_fp8 <= TOL and not torch.equal(fp8, r["sharded"])
    for name in ("prefill", "decode"):
        single, sharded = r[name]
        s = float(single.abs().max())
        assert _rel(sharded, single, s) <= TOL, name
    # every leaf the rules shard is held in its shard only, by bytes
    for rank in r["nbytes"]:
        for path, full, local, n in rank:
            assert local * n == full, (path, full, local, n)
    assert any(n > 1 for path, _, _, n in r["nbytes"][0]
               if "blocks" in path)
    assert r["embeds"] == 4                  # 2 forwards, prefill, decode
    fwd, pf, dc = r["calls"]
    cfg = _jcfg(arch)
    n_moe = sum(sp.ffn == "moe" for sp in cfg.prefix) \
        + cfg.n_repeats * sum(sp.ffn == "moe" for sp in cfg.block)
    body = "ep_full_body" if ep_full else "ep_moe"
    want = {k: 0 for k in ("ep_small", "ep_moe", "ep_full_body")}
    if n_moe:
        assert fwd == {**want, body: 2 * n_moe}
        assert pf == {**want, body: n_moe}
        assert dc == {**want, "ep_small": n_moe}        # B = 1: one token
    else:
        assert fwd == pf == dc == want


#: a sharded step's gradients against the single-device port's, x the
#: leaf's max |g|: float32 sums taken in another order (the model dim's
#: partial products, the data dim's halves of the batch) move a leaf by a
#: few float32 roundings of its largest entry; a gradient that misses a
#: shard's contribution (the tied embedding's, say) is off by its own size
GRAD_TOL = 1e-5


def test_sharded_train_step_gradients_match_single_device(group):
    """The vocab-sharded embedding's backward (the masked take, the sum
    over the model dim, the table's gradient summed over the data dim)
    and the tied head's: every leaf's gradient equals the single-device
    port's within ``GRAD_TOL``."""
    res, _ = group
    r = res["train"]
    assert r["embeds"] == 1
    loss, loss_s = r["loss"]
    assert abs(float(loss) - float(loss_s)) <= 1e-6 * abs(float(loss))
    worst = {}
    for path, g, gs in r["grads"]:
        assert gs.shape == g.shape, path
        worst[path] = float((gs.double() - g.double()).abs().max()) \
            / max(float(g.abs().max()), 1e-30)
    print(f"gradient error / max |g|: "
          f"{ {k: float(f'{v:.3g}') for k, v in sorted(worst.items())} }")
    assert "embed.tok" in worst
    assert max(worst.values()) <= GRAD_TOL, worst
