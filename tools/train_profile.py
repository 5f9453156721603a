#!/usr/bin/env python3
"""Where a train step of a model at its published widths spends its time
on one card.

    python3 tools/train_profile.py [--steps 3]
    python3 tools/train_profile.py --arch rwkv6-7b --repeats 8
    python3 tools/train_profile.py --arch rwkv6-7b --repeats 8 \
        --seq-len 4096 --global-batch 2

The step is ``chip_smoke.py``'s phase o's (llama3.2-1b at its depth, the
default) or phase p's (rwkv6-7b cut to ``--repeats`` repeats of the
block): AdamW, remat "full", 2 microbatches of ``--global-batch`` / 2 x
``--seq-len`` tokens (by default 4 x 128), bf16.
After two warm-up steps it prints the wall of a step's parts, each ended
by a synchronise (the forward + backward of one microbatch, the float32
accumulation, the AdamW update), then profiles ``--steps`` whole steps with
``torch.profiler`` and prints the kernels by device time, the device
time over the wall (the busy share; one stream, so kernels do not
overlap), the device time of the WKV forward and backward kernels (and
their share of the step's device time) and of the matrix products, and
the step's FLOP rate against the bf16 peak.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: the published dense bf16 peak of one H100 SXM (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    import torch
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
    from repro_torch.runtime.train_loop import make_train_step, value_and_grad

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    args = ap.parse_args(argv)
    if args.global_batch % 2:
        ap.error("--global-batch must be even (two microbatches)")
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    if args.repeats is not None:
        cfg = dataclasses.replace(cfg, n_repeats=args.repeats)
    print(f"{cfg.name}, {cfg.n_repeats} repeats of the block", flush=True)
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=0)
    micro = args.global_batch // 2

    def batch(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch(s).items()}

    params = init_model(0, cfg, dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, n_microbatches=2, lr_peak=1e-4, warmup=5,
                           total_steps=6)
    for s in range(2):
        params, opt, m = step(params, opt, batch(s))
    float(m["loss"])

    # the parts of a step, each ended on the device
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    b = batch(2)
    mb = {k: v[:micro] for k, v in b.items()}
    (_, g), t_vg = timed(lambda: value_and_grad(params, mb, cfg=cfg))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for p in _tree.leaves(params)]
    _, t_acc = timed(lambda: [a.add_(x) for a, x in zip(
        acc, _tree.leaves(g))])
    grads = _tree.unflatten(_tree.flatten(params)[1],
                            [(a / 2).to(torch.bfloat16) for a in acc])
    _, t_opt = timed(lambda: adamw_update(
        params, grads, opt, lr=cosine_warmup(1e-4, 5, 6)))
    del g, acc, grads
    print(f"parts: forward + backward of one microbatch ({micro} x "
          f"{args.seq_len} tokens, remat full) {t_vg:.1f} ms; float32 "
          f"accumulation {t_acc:.1f} "
          f"ms; AdamW update {t_opt:.1f} ms", flush=True)

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(args.steps):
            params, opt, m = step(params, opt, batch(3 + s))
            float(m["loss"])
        wall = time.perf_counter() - t0
    # the device's own rows (kernels, copies): a host op's row also carries
    # as self time a kernel launched outside any aten op inside it (the
    # WKV's ctypes launches inside its operator), which would count it twice
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy = sum(r[2] for r in kernels) / 1e6
    per = wall / args.steps
    flop = 6 * sum(t.numel() for t in _tree.leaves(params)) \
        * args.seq_len * args.global_batch
    rate = flop / per
    print(f"{args.steps} steps: wall {per * 1e3:.1f} ms a step, device "
          f"time {busy / args.steps * 1e3:.1f} ms a step, busy share "
          f"{busy / wall:.3f}; 6 N D = {flop / 1e12:.2f} TFLOP a step: "
          f"{rate / 1e12:.1f} TFLOP/s, {rate / BF16_FLOP_PER_S:.4f} of the "
          f"bf16 peak", flush=True)
    groups = {"WKV forward (wkv6_chunked_kernel)": "wkv6_chunked",
              "WKV backward (wkv6_bwd_*_kernel)": "wkv6_bwd",
              "matrix products (gemm / nvjet / cutlass)": None}
    wkv_us = 0.0
    for label, key in groups.items():
        if key is None:
            us = sum(r[2] for r in kernels
                     if any(m in r[0].lower()
                            for m in ("gemm", "nvjet", "cutlass")))
        else:
            us = sum(r[2] for r in kernels if key in r[0])
            wkv_us += us
        print(f"  {label}: {us / 1e3 / args.steps:.2f} ms a step, "
              f"{us / 1e6 / busy:.4f} of the device time", flush=True)
    print(f"  WKV forward and backward: {wkv_us / 1e3 / args.steps:.2f} ms "
          f"a step, {wkv_us / 1e6 / busy:.4f} of the device time",
          flush=True)
    for name, count, us in kernels[:25]:
        print(f"  {us / 1e3 / args.steps:9.2f} ms a step  {count:6d}  "
              f"{name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
