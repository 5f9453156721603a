"""Multi-pod dry-run — the port of ``repro.launch.dryrun``: trace one whole
step of every (arch × shape × mesh) cell over a fake world of 256 / 512
ranks and report its per-rank roofline terms and memory.  Nothing is
allocated on a card.

How a cell runs: the process joins torch's fake process group
(``FakeStore``: ``world`` ranks in one process, rank 0's view, collectives
return at once), builds :func:`~repro_torch.launch.mesh.make_production_mesh`,
draws the parameters and optimizer state as fake tensors
(:func:`~repro_torch.launch.steps.model_state_shapes`), distributes them
and the inputs under the port's sharding rules, and runs one step under
``FakeTensorMode`` inside a :class:`~repro_torch.launch.roofline.StepTrace`:
the train step with its microbatches, remat and AdamW or Adafactor
update, or the prefill, or the decode.  The FLOPs, HBM bytes and
collective bytes are one rank's, counted op by op on its local shards.
Decode caches are held as the port holds them under a mesh, replicated
(``parallel.sharding.replicated``: a cache write has no DTensor rule);
``memory_analysis["caches_sharded_bytes"]`` gives what the rules'
sharded caches would take a rank.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
      --subprocess --out results/dryrun
  ... --device cpu     (fake CPU tensors: no card needed)

The default device is ``cuda``: fake CUDA tensors, traced on a machine
with a card (a CPU-only torch cannot run ops on them); without a card it
raises unless ``--device cpu`` is given.  ``--subprocess`` runs every cell
in a fresh interpreter.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

from ..configs import ARCH_IDS, get_config
from ..models import SHAPE_CELLS, ModelCtx, shape_cell

__all__ = ["run_cell", "trace_cell", "should_skip", "fake_world",
           "sharded_bytes", "main", "SKIP"]

SKIP = "skip"


def should_skip(cfg, cell) -> Optional[str]:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: 500k dense KV per layer is not "
                "sub-quadratic; skipped per brief (DESIGN.md §4)")
    return None


@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of torch's fake process group of ``world`` ranks, for the
    body of the ``with``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _forget_world()


def _forget_world() -> None:
    """Clear DTensor's plans of the world just left.  It caches them by
    value -- the next world's mesh of the same shape compares equal --
    and they name that world's process groups."""
    import torch
    from torch.distributed.tensor import DTensor, _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(_redistribute, "_gen_transform_infos", None),
               getattr(prop.propagate_op_sharding, "cache", None),
               getattr(type(prop), "_propagate_tensor_meta_cached", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    getattr(_redistribute, "clear_redistribute_planner_cache", lambda: None)()
    # the C++ dispatch's own cache of the same plans, where torch has one
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
            lambda: None)()


def _materialize(template, device):
    """A cache template's ``(shape, dtype)`` leaves as tensors (fake under
    the caller's ``FakeTensorMode``)."""
    import torch
    from .. import _tree
    from ..parallel.sharding import _is_template
    return _tree.map(lambda t: torch.zeros(t[0], dtype=t[1], device=device),
                     template, is_leaf=_is_template)


def sharded_bytes(template, specs, mesh) -> int:
    """Bytes a rank would hold of the ``(shape, dtype)`` leaves of
    ``template`` under their PartitionSpecs ``specs``."""
    from .. import _tree
    from ..parallel.sharding import _is_template, is_spec, mesh_shape
    ms = mesh_shape(mesh)
    leaves = _tree.leaves(template, is_leaf=_is_template)
    total = 0
    for (shape, dtype), spec in zip(leaves,
                                    _tree.leaves(specs, is_leaf=is_spec)):
        n = 1
        for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-d // math.prod(ms[a] for a in names))
        total += n * dtype.itemsize
    return total


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             fsdp: bool = True, microbatches: Optional[int] = None,
             opt_state_dtype: str = "bfloat16",
             ep_full: bool = False, acc_dtype: str = "float32",
             a2a_fp8: bool = False, optimizer: str = "adamw",
             remat_policy: str = "full",
             save_dir: Optional[str] = None, verbose: bool = True,
             tag: str = "", device="cuda") -> dict:
    """Trace one cell's step over a fake world of 256 (``multi_pod``: 512)
    ranks and return its record (saved under ``save_dir`` when given)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    cfg = get_config(arch)
    cell = shape_cell(shape)
    mesh_desc = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.time()

    reason = should_skip(cfg, cell)
    if reason:
        rec = {"arch": cfg.name, "cell": cell.name, "mesh": mesh_desc,
               "status": SKIP, "reason": reason}
        _save(rec, save_dir, cfg.name, cell.name, mesh_desc)
        if verbose:
            print(f"[dryrun] SKIP {cfg.name} × {cell.name} × {mesh_desc}: "
                  f"{reason}")
        return rec

    with fake_world(512 if multi_pod else 256):
        from .mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
        if dev.type == "cuda":
            # the first fake CUDA tensor makes FakeTensorMode's real CUDA
            # context (one 4-byte tensor): made before the count
            import torch
            from torch._subclasses.fake_tensor import FakeTensorMode
            with FakeTensorMode():
                torch.empty(1, device=dev)
        before = _card_allocations(dev)
        rep, n_micro, cache_bytes, t_trace = trace_cell(
            cfg, cell, mesh, dev, fsdp=fsdp, microbatches=microbatches,
            opt_state_dtype=opt_state_dtype, ep_full=ep_full,
            acc_dtype=acc_dtype, a2a_fp8=a2a_fp8, optimizer=optimizer,
            remat_policy=remat_policy, mesh_desc=mesh_desc)
        after = _card_allocations(dev)
    rec = rep.to_json()
    # what the trace allocated on the card (fake tensors hold nothing),
    # and the process's peak there (the mesh's construction included)
    rec["card_allocations"] = None if after is None else after - before
    rec["card_bytes_allocated"] = None
    if dev.type == "cuda":
        import torch
        rec["card_bytes_allocated"] = torch.cuda.max_memory_allocated(dev)
    if cache_bytes is not None:
        rec["memory_analysis"]["caches_sharded_bytes"] = float(cache_bytes)
    rec.update(status="ok", tag=tag, ep_full=ep_full, a2a_fp8=a2a_fp8,
               optimizer=optimizer, acc_dtype=acc_dtype,
               remat_policy=remat_policy, device=dev.type,
               trace_s=round(t_trace, 1),
               wall_s=round(time.time() - t0, 1),
               n_chips=512 if multi_pod else 256, fsdp=fsdp,
               microbatches=n_micro,
               param_count=cfg.param_count(),
               active_param_count=cfg.active_param_count())
    if verbose:
        ma = rec["memory_analysis"]
        print(f"[dryrun] OK {cfg.name} × {cell.name} × {mesh_desc} "
              f"(trace {rec['trace_s']:.0f}s, wall {rec['wall_s']:.0f}s)")
        print("  memory_analysis: "
              + ", ".join(f"{k.rsplit('_', 1)[0]}={v / 2**30:.2f}GiB"
                          for k, v in ma.items() if v))
        print(f"  cost: {rec['flops_per_device']:.3e} FLOPs/dev, "
              f"{rec['bytes_per_device']:.3e} B/dev, "
              f"coll {rec['coll_bytes_per_device']:.3e} B/dev")
        print(f"  roofline: compute {rec['t_compute']*1e3:.2f}ms, memory "
              f"{rec['t_memory']*1e3:.2f}ms, collective "
              f"{rec['t_collective']*1e3:.2f}ms → {rec['bottleneck']}-bound; "
              f"useful-FLOP ratio {rec['useful_ratio']:.3f}")
    _save(rec, save_dir, cfg.name, cell.name, mesh_desc)
    return rec


def trace_cell(cfg, cell, mesh, device, *, fsdp: bool = True,
               microbatches: Optional[int] = None,
               opt_state_dtype: Optional[str] = "bfloat16",
               ep_full: bool = False, acc_dtype: str = "float32",
               a2a_fp8: bool = False, optimizer: str = "adamw",
               remat_policy: str = "full", mesh_desc: str = "1x1"):
    """Trace one step of ``cell`` under ``FakeTensorMode`` on ``device``:
    over ``mesh`` (a DeviceMesh of a fake world; the parameters, optimizer
    state and inputs distributed under the sharding rules, the caches
    replicated) or, with ``mesh`` None, on one device.  Returns (the
    report, the microbatches, a rank's bytes of the rules' sharded caches
    or None, the trace's seconds)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..parallel.ops import replicating
    from ..parallel.sharding import (distribute, opt_state_shardings,
                                     param_shardings, replicated)
    from .roofline import StepTrace, roofline_from_trace
    from .specs import input_shardings, input_specs, microbatches_for
    from .steps import (build_decode_fn, build_prefill_fn, build_train_fn,
                        model_state_shapes)

    dev = torch.device(device)
    ctx = ModelCtx(remat_policy=remat_policy, mesh=mesh, model_axis="model",
                   ep_full=ep_full, a2a_fp8=a2a_fp8)
    fake = FakeTensorMode()
    specs = input_specs(cfg, cell, device=dev, fake_mode=fake)
    params, opt = model_state_shapes(cfg, opt_state_dtype=opt_state_dtype,
                                     optimizer=optimizer, device=dev,
                                     fake_mode=fake)
    n_micro = microbatches_for(cfg, cell, mesh, microbatches) \
        if mesh is not None else (microbatches or 1)
    cache_bytes = None
    with fake:
        batch = {k: v for k, v in specs.items() if k != "caches"}
        if cell.kind != "train":
            caches = _materialize(specs["caches"], dev)
        if mesh is not None:
            in_shard = input_shardings(specs, mesh, cell)
            p_shard = param_shardings(params, mesh, fsdp=fsdp,
                                      moe_full_ep=ep_full)
            params = distribute(params, p_shard, mesh)
            batch = {k: distribute(v, in_shard[k], mesh)
                     for k, v in batch.items()}
            if cell.kind == "train":
                opt = distribute(opt, opt_state_shardings(opt, p_shard),
                                 mesh)
            else:
                caches = replicated(caches, mesh)
                cache_bytes = sharded_bytes(specs["caches"],
                                            in_shard["caches"], mesh)
        args = {"params": params, "batch": batch}
        if cell.kind == "train":
            args["opt_state"] = opt
        else:
            del opt
            args["caches"] = caches
        t0 = time.time()
        with replicating(), StepTrace(args) as trace:
            if cell.kind == "train":
                fn = build_train_fn(cfg, ctx, n_micro,
                                    opt_state_dtype=opt_state_dtype,
                                    acc_dtype=acc_dtype, optimizer=optimizer)
                out = fn(params, opt, batch)
            else:
                with torch.no_grad():
                    if cell.kind == "prefill":
                        out = build_prefill_fn(cfg, ctx)(params, batch,
                                                         caches)
                    else:
                        out = build_decode_fn(cfg, ctx)(
                            params, batch["tokens"], batch["pos"], caches,
                            batch.get("enc_out"))
            del out
        t_trace = time.time() - t0
    n_chips = mesh.size() if mesh is not None else 1
    return (roofline_from_trace(trace, cfg, cell, mesh_desc, n_chips),
            n_micro, cache_bytes, t_trace)


def _card_allocations(dev) -> Optional[int]:
    """Allocations the caching allocator has made on ``dev`` so far (None
    off the card)."""
    if dev.type != "cuda":
        return None
    import torch
    return torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)


def _save(rec: dict, save_dir: Optional[str], arch: str, cell: str,
          mesh: str):
    if not save_dir:
        return
    os.makedirs(save_dir, exist_ok=True)
    safe = arch.replace("/", "_").replace(".", "_")
    tag = rec.get("tag") or ""
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(save_dir, f"{safe}__{cell}__{mesh}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--opt-state-dtype", default="bfloat16")
    ap.add_argument("--ep-full", action="store_true")
    ap.add_argument("--acc-dtype", default="float32")
    ap.add_argument("--remat-policy", default="full")
    ap.add_argument("--a2a-fp8", action="store_true")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (needs a card) "
                         "or cpu")
    ap.add_argument("--subprocess", action="store_true",
                    help="isolate each cell in a fresh interpreter")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = [c.name for c in SHAPE_CELLS] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.subprocess:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", "multi" if mp else "single",
                           "--out", args.out, "--device", args.device,
                           "--opt-state-dtype", args.opt_state_dtype,
                           "--acc-dtype", args.acc_dtype,
                           "--remat-policy", args.remat_policy,
                           "--optimizer", args.optimizer]
                    for flag in ("no_fsdp", "ep_full", "a2a_fp8"):
                        if getattr(args, flag):
                            cmd.append("--" + flag.replace("_", "-"))
                    if args.microbatches:
                        cmd += ["--microbatches", str(args.microbatches)]
                    if args.tag:
                        cmd += ["--tag", args.tag]
                    if subprocess.run(cmd).returncode:
                        failures.append((arch, shape, mp))
                    continue
                try:
                    run_cell(arch, shape, mp, fsdp=not args.no_fsdp,
                             microbatches=args.microbatches,
                             opt_state_dtype=args.opt_state_dtype,
                             ep_full=args.ep_full, acc_dtype=args.acc_dtype,
                             a2a_fp8=args.a2a_fp8, optimizer=args.optimizer,
                             remat_policy=args.remat_policy, tag=args.tag,
                             save_dir=args.out, device=args.device)
                except Exception:
                    traceback.print_exc()
                    failures.append((arch, shape, mp))
    if failures:
        print("FAILED cells:", failures)
        return 1
    print("all requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
