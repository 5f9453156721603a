#!/usr/bin/env python3
"""Loss over a few train steps of a model at its published widths (llama3.2-1b
at its depth by default), for several peak learning rates and parameter
dtypes, on one card.

    python3 tools/train_lr_probe.py [--steps 6] [--warmup 5]
    python3 tools/train_lr_probe.py --arch rwkv6-7b --repeats 8 --bf16-only

Each run draws the model from seed 0 and trains it with the port's
``make_train_step`` (AdamW, cosine warmup, 2 microbatches) on the stream
``chip_smoke.py``'s phase o uses (8 x 128 tokens a step, seed 0), or on
step 0's batch at every step ("fixed batch"), and prints the loss of
every step.  It shows which peak lr the 6-step gate of phase o can hold
to: with 1 024 tokens a step and a 5-step warmup, Adam's first updates
move every weight by about the lr.  ``--repeats`` cuts the depth to that
many repeats of the block (``chip_smoke.py``'s phase p trains rwkv6-7b at
8); ``--bf16-only`` skips the float32 runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: (parameter dtype, peak lr, fixed batch)
RUNS = (("bfloat16", 3e-3, False), ("bfloat16", 3e-4, False),
        ("bfloat16", 1e-4, False), ("bfloat16", 3e-5, False),
        ("bfloat16", 3e-4, True), ("bfloat16", 1e-4, True),
        ("float32", 3e-4, False), ("float32", 1e-4, False))


def main(argv=None) -> int:
    import subprocess

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--bf16-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = get_config(args.arch)
    if args.repeats is not None:
        base = dataclasses.replace(base, n_repeats=args.repeats)
    print(f"{base.name}, {base.n_repeats} repeats of the block", flush=True)
    stream = TokenStream(vocab=base.vocab, seq_len=128, global_batch=8,
                         seed=0)

    def batch(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch(s).items()}

    for dtype, lr, fixed in RUNS:
        if args.bf16_only and dtype != "bfloat16":
            continue
        cfg = dataclasses.replace(base, dtype=dtype)
        params = init_model(0, cfg, dev)
        opt = adamw_init(params)
        step = make_train_step(cfg, n_microbatches=2, lr_peak=lr,
                               warmup=args.warmup, total_steps=args.steps)
        losses = []
        t0 = time.perf_counter()
        for s in range(args.steps):
            params, opt, m = step(params, opt, batch(0 if fixed else s))
            losses.append(round(float(m["loss"]), 4))
        print(f"{dtype} peak lr {lr:g} "
              f"{'fixed batch' if fixed else 'stream'}: loss by step "
              f"{losses} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del params, opt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
