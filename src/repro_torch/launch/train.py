"""Training launcher — the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt

Runs the full operational loop (data pipeline → train step →
checkpoint/restart) on ``--device`` (default ``cuda``; ``cpu`` runs the
plain-torch path).  ``--smoke`` (the default) selects the reduced config,
``--full`` the published widths.  ``--resume`` restores the latest
checkpoint and continues — kill it mid-run and relaunch to see the
fault-tolerance path.  ``--hetero-profile`` prints the paper-driven
unequal shard plan.  The exit code is 0 only if the loss improved.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    from ..runtime.train_loop import _default_ckpt_dir
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=_default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hetero-profile", default=None,
                    help="'ec2' or 'tpu' — print the Thm-1 shard plan")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "plain-torch path)")
    args = ap.parse_args(argv)

    from ..configs import get_config, get_smoke_config
    from ..data import TokenStream
    from ..device import resolve_device
    from ..runtime.train_loop import TrainLoop, TrainLoopConfig

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} "
          f"layers={cfg.n_layers} device={dev}")

    if args.hetero_profile:
        from ..parallel.hetero import coded_batch_plan, hetero_split
        from ..sim.cluster import ec2_cluster, tpu_pod_cluster
        prof = (ec2_cluster(N=8, n_fast=3) if args.hetero_profile == "ec2"
                else tpu_pod_cluster(n_pods=8, degraded=(3,)))
        split = hetero_split(prof, args.batch * 8)
        coded, t = coded_batch_plan(prof, args.batch * 8)
        print(f"[hetero] Thm-1 split over {prof.N} groups: {split.tolist()}")
        print(f"[hetero] coded loads (k-of-n tolerant): {coded.tolist()}, "
              f"predicted completion {t:.2f}ms")

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    extra = {}
    if cfg.enc_dec:
        extra["enc_feats"] = np.full(
            (args.batch, cfg.frontend_len, cfg.frontend_dim), 0.1, np.float32)
    if cfg.frontend == "vision":
        extra["patch_feats"] = np.full(
            (args.batch, cfg.frontend_len, cfg.frontend_dim), 0.1, np.float32)

    loop = TrainLoop(cfg, TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, n_microbatches=args.microbatches,
        lr_peak=args.lr, warmup=max(args.steps // 10, 5)),
        stream, rng_seed=args.seed, extra_feats=extra, device=dev)

    if args.resume and loop.try_restore():
        print(f"[train] resumed from step {loop.step}")

    hist = loop.run(callback=lambda s, m: print(
        f"[train] step {s:5d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
        f"({m['wall_s']:.0f}s)"))
    first, last = hist[0][1]["loss"], hist[-1][1]["loss"]
    print(f"[train] done: loss {first:.4f} → {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
