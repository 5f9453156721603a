"""One rank of the 2 x 2 gloo group of ``tests/test_torch_distributed.py``
(no jax here: the test's process computes the reference's side).

Each rank loads the reference's smoke parameters (``params_from_numpy``),
runs the port's single-device forward, then the sharded one on a
("data" 2, "model" 2) mesh: ``model_fwd`` twice (bit-equal), ``prefill``
and a B = 1 ``decode_step``; for the MoE configs also under ``ep_full``,
and one forward with float8 dispatch payloads (``a2a_fp8``); then one
training step's loss and gradients of llama3.2-1b on the mesh beside the
single-device port's.  Rank 0 saves every result, with the bytes each rank holds of each leaf
and the expert-parallel bodies run, for the test to check.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys
from pathlib import Path

import torch


def _cfg(arch: str):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:
        # capacity competition depends on the dispatch group: uncapped,
        # local and expert-parallel dispatch drop nothing and must agree
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    return cfg


def _bytes(params, mesh) -> list:
    """(path, full bytes, this rank's bytes, the product of the mesh dims
    the leaf's spec shards it over) per leaf."""
    from repro_torch.parallel import sharding as sh
    specs = sh.param_shardings(params, mesh)
    ms = sh.mesh_shape(mesh)
    out = []
    for (path, t), (_, spec) in zip(sh._paths(params), sh._paths(specs)):
        n = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                n *= ms[a] if a is not None else 1
        out.append((path, t.numel() * t.element_size(),
                    sh.local_nbytes(t), n))
    return out


def _caches(cfg, B: int, max_len: int):
    from repro_torch.launch.serve import zero_caches
    return zero_caches(cfg, B, max_len, device="cpu")


def _fp8_single(params, batch, cfg):
    """The single-device forward with each expert's inputs rounded through
    float8_e4m3fn, as the float8 dispatch rounds them (rounding twice
    changes nothing)."""
    from repro_torch.models import model_fwd, moe
    ffn = moe._expert_ffn

    def rounded(w_in, w_gate, w_out, xs):
        return ffn(w_in, w_gate, w_out,
                   xs.to(torch.float8_e4m3fn).to(xs.dtype))
    moe._expert_ffn = rounded
    try:
        return model_fwd(params, batch, cfg=cfg)["logits"]
    finally:
        moe._expert_ffn = ffn


def _train_grads(item, mesh) -> dict:
    """One training step's loss and gradients of ``item``'s config (the
    job's first, llama3.2-1b) in float32, on one device and on the mesh
    (the sharded embedding, tensor and data parallelism): the loss and
    every gradient leaf of both, the sharded ones as full tensors, and the
    sharded embeddings taken."""
    from repro_torch import _tree
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import ModelCtx
    from repro_torch.parallel import ops as pops
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.train_loop import value_and_grad
    arch, tree, batch = item
    cfg = _cfg(arch)
    tp = _tree.map(lambda t: t.float(),
                   params_from_numpy(tree, cfg, device="cpu"))
    tok = torch.from_numpy(batch["tokens"])
    tb = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    loss, grads = value_and_grad(tp, tb, cfg=cfg)
    emb0 = pops.EMBED_CALLS
    loss_s, grads_s = value_and_grad(sh.shard_params(tp, mesh), tb, cfg=cfg,
                                     ctx=ModelCtx(mesh=mesh))

    def full(t):
        return t.full_tensor() if pops.is_dtensor(t) else t
    return dict(loss=(loss, full(loss_s)),
                grads=[(path, g, full(gs)) for (path, g), (_, gs)
                       in zip(sh._paths(grads), sh._paths(grads_s))],
                embeds=pops.EMBED_CALLS - emb0)


def run(rank: int, world: int, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import init_group, make_local_mesh
    from repro_torch.models import ModelCtx, decode_step, model_fwd, prefill
    from repro_torch.models import moe
    from repro_torch.parallel import ops as pops
    from repro_torch.parallel import sharding as sh
    torch.manual_seed(0)
    torch.set_num_threads(1)
    work = Path(work)
    init_group(rank, world, f"file://{work / 'store'}", backend="gloo")
    mesh = make_local_mesh(2, "cpu")
    job = pickle.loads((work / "job.pkl").read_bytes())
    res = {}
    with torch.no_grad():
        for arch, tree, batch in job:
            cfg = _cfg(arch)
            tp = params_from_numpy(tree, cfg, device="cpu")
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            single = model_fwd(tp, tb, cfg=cfg)["logits"]
            tok1 = tb["tokens"][:1]
            P = tok1.shape[1] // 2
            c0 = _caches(cfg, 1, tok1.shape[1])
            pf0, c0 = prefill(tp, {"tokens": tok1[:, :P]}, c0, cfg=cfg)
            dc0, _ = decode_step(tp, tok1[:, P:P + 1], torch.full((1,), P),
                                 c0, cfg=cfg)
            for ep_full in ((False, True) if cfg.moe is not None
                            else (False,)):
                ps = sh.shard_params(tp, mesh, moe_full_ep=ep_full)
                ctx = ModelCtx(mesh=mesh, ep_full=ep_full)
                calls0 = dict(moe.EP_CALLS)
                emb0 = pops.EMBED_CALLS
                out = [model_fwd(ps, tb, cfg=cfg, ctx=ctx)["logits"]
                       .full_tensor() for _ in range(2)]
                fwd_calls = {k: moe.EP_CALLS[k] - calls0[k] for k in calls0}
                c = sh.replicated(_caches(cfg, 1, tok1.shape[1]), mesh)
                calls1 = dict(moe.EP_CALLS)
                pf, c = prefill(ps, {"tokens": tok1[:, :P]}, c, cfg=cfg,
                                ctx=ctx)
                pf_calls = {k: moe.EP_CALLS[k] - calls1[k] for k in calls1}
                calls2 = dict(moe.EP_CALLS)
                dc, _ = decode_step(ps, tok1[:, P:P + 1], torch.full((1,), P),
                                    c, cfg=cfg, ctx=ctx)
                dc_calls = {k: moe.EP_CALLS[k] - calls2[k] for k in calls2}
                embeds = pops.EMBED_CALLS - emb0
                fp8 = (model_fwd(ps, tb, cfg=cfg, ctx=ModelCtx(
                    mesh=mesh, ep_full=True, a2a_fp8=True))["logits"]
                    .full_tensor(), _fp8_single(tp, tb, cfg)) \
                    if ep_full else None
                res[(arch, ep_full)] = dict(
                    single=single, sharded=out[0], again=out[1], fp8=fp8,
                    prefill=(pf0, pf.full_tensor()),
                    decode=(dc0, dc.full_tensor()),
                    calls=(fwd_calls, pf_calls, dc_calls),
                    embeds=embeds,
                    nbytes=_bytes(ps, mesh))
                del ps
    res["train"] = _train_grads(job[0], mesh)
    gathered = [None] * world if rank == 0 else None
    dist.gather_object({k: v["nbytes"] for k, v in res.items()
                        if k != "train"}, gathered, dst=0)
    if rank == 0:
        for k, v in res.items():
            if k != "train":
                v["nbytes"] = [g[k] for g in gathered]
        torch.save(res, work / "result.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
