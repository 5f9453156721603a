#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints what is worth keeping; any failure raises and the run
exits non-zero):

  a. the card: ``nvidia-smi`` name and power limit;
  b. build: every CUDA source in ``src/repro_torch/csrc`` compiled for
     sm_90a, one ``nvcc`` per source, all started together;
  c. each kernel against its plain-torch version at the coded-serving
     shapes of llama3.2-1b (L = 128 512 head rows, D = 2048), with its
     time (CUDA events, median), the plain version's time, a one-call
     PyTorch yardstick where one exists, and the least time the card could
     take (bytes over HBM rate, or operations over the peak of their type);
  d. uncoded serving of llama3.2-1b at its published widths (bf16):
     prefill and decode tokens/s;
  e. coded serving of llama3.2-1b at its published widths: head scope,
     batched engine, virtual parity, device products, ``"torch"`` backend,
     one master, a seed whose covering prefix needs a ~49k-row parity
     solve; decode-solve sizes, peak memory, wall time, max_err and the
     argmax match rate against the uncoded head (measurements, not gates);
  f. coded serving at smoke size, materialised and virtual parity, through
     ``serve_policy_sweep`` (which asserts ``decode_ok``);
  g. one JSON line with every kernel's numbers and its launches on the
     main path (phases e and f, counts reset just before e), then the
     result line.

Exits non-zero without a result when no CUDA device is visible, or when
the repository's ``src`` is not beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published peaks of one H100 SXM (NVIDIA data sheet / Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12            # outside the tensor cores
INT32_OP_PER_S = 33.5e12          # white paper's INT32 figure
#: integer ALU operations per counter-derived parity entry: two threefry
#: calls of 2 + 20 x 3 (add, funnel shift, xor) + 5 x 2 key injections,
#: plus the column doubling and four >> 8 shifts
INT_OPS_PER_ENTRY = 2 * (2 + 20 * 3 + 5 * 2) + 2 + 4
#: float32 operations per entry: four scalings, three adds, the -2, x scale
F32_OPS_PER_ENTRY = 9

ARCH = "llama3.2-1b"
#: phase e's seed: its first (and frozen) covering prefix needs a parity
#: solve (phase e prints its size; 48 876 rows, the phase-c lane count)
CODED_SEED = 1
CODED_REQUESTS, CODED_PROMPT, CODED_GEN, CODED_SLOTS = 4, 16, 4, 4
#: the phase-c shapes: the packed head tiles of one step (128 512 rows
#: in 1004 tiles of 128), the step batch, phase e's parity lanes
TILES, TILE, D, BATCH = 1004, 128, 2048, CODED_SLOTS
L_HEAD = 128512
GEN_LANES = 48876


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` runs (one warm-up
    run first)."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_once(fn):
    """CUDA-event time of one cold call of ``fn`` and its result (for the
    plain versions that take seconds)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def bound(bytes_moved: float, op_times) -> tuple:
    """Least time (ms) for the work: the larger of the bytes over the HBM
    rate and each operation type's count over its peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(op_times) if op_times else 0.0
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_c(dev) -> dict:
    """Each kernel against its plain version at the serving shapes."""
    import numpy as np
    import torch
    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, source, replaces, err, tol, ms, plain_ms, lib_ms,
               bnd):
        ok = err <= tol
        print(f"[c] {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]})", flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err} > {tol})")
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bnd[0],
                          bound_by=bnd[1], library_ms=lib_ms)

    # -- coded_matvec: one step's packed head tiles against the batch -----
    tiles = torch.randn((TILES, TILE, D), generator=gen, device=dev) * 0.02
    x = torch.randn((D, BATCH), generator=gen, device=dev)
    got = ops.coded_shard_matmul_batch(tiles, x).reshape(-1, BATCH)
    flat = tiles.reshape(-1, D)
    want = ref.coded_matvec_ref(flat, x)
    n = TILES * TILE
    report("coded_matvec", "src/repro_torch/csrc/coded_matvec.cu",
           "src/repro/kernels/coded_matvec.py:38",
           max_err(got, want), 1e-4 * (1 + float(want.abs().max())),
           time_ms(lambda: ops.coded_shard_matmul_batch(tiles, x)),
           time_ms(lambda: ref.coded_matvec_ref(flat, x)),
           time_ms(lambda: torch.matmul(flat, x)),
           bound(4.0 * (n * D + D * BATCH + n * BATCH),
                 [2.0 * n * D * BATCH / F32_FLOP_PER_S]))
    del tiles, flat, got, want

    # -- counter_parity_rows: one 256-row parity block, bit-equal ----------
    key = (0x1234ABCD, 0x9E3779B8)
    ctrs = mds.parity_counters(np.arange(256), 0)
    ctrs_t = torch.from_numpy(ctrs.astype(np.int64)).to(dev)
    cols = torch.arange(L_HEAD, device=dev)
    scale = ops.parity_scale(L_HEAD)
    got = ops.counter_parity_rows(key, L_HEAD, ctrs, device=dev)
    want = ref.counter_parity_rows_ref(key, scale, ctrs_t, cols)
    host = mds.counter_parity_rows(key, ctrs[:4], L_HEAD, dtype=np.float32)
    if not (torch.equal(got, want)
            and np.array_equal(got[:4].cpu().numpy(), host)):
        raise AssertionError("counter_parity_rows is not bit-equal")
    ents = 256 * L_HEAD
    report("counter_parity_rows", "src/repro_torch/csrc/mds_encode.cu",
           "src/repro/kernels/mds_encode.py:65", max_err(got, want), 0.0,
           time_ms(lambda: ops.counter_parity_rows(key, L_HEAD, ctrs_t,
                                                   device=dev)),
           time_ms(lambda: ref.counter_parity_rows_ref(key, scale, ctrs_t,
                                                       cols), 3),
           None,
           bound(4.0 * (ents + 256 + L_HEAD),
                 [ents * INT_OPS_PER_ENTRY / INT32_OP_PER_S,
                  ents * F32_OPS_PER_ENTRY / F32_FLOP_PER_S]))
    del got, want

    # -- gen_parity_matvec: phase e's parity lanes against resident W ------
    w = torch.randn((L_HEAD, D), generator=gen, device=dev) * 0.02
    xg = torch.randn((D, BATCH), generator=gen, device=dev)
    gctrs = torch.from_numpy(
        mds.parity_counters(np.arange(GEN_LANES), 0).astype(np.int64)).to(dev)
    got = ops.gen_parity_products(key, gctrs, w, xg)
    plain_ms, want = time_once(
        lambda: ref.gen_parity_ref(key, scale, gctrs, w, xg))
    ents = GEN_LANES * L_HEAD
    report("gen_parity_matvec", "src/repro_torch/csrc/mds_encode.cu",
           "src/repro/kernels/mds_encode.py:116",
           max_err(got, want), 1e-4 * (1 + float(want.abs().max())),
           time_ms(lambda: ops.gen_parity_products(key, gctrs, w, xg)),
           plain_ms, None,
           bound(4.0 * (L_HEAD * D + D * BATCH + GEN_LANES
                        + GEN_LANES * BATCH),
                 [ents * INT_OPS_PER_ENTRY / INT32_OP_PER_S,
                  (ents * (F32_OPS_PER_ENTRY + 2 * BATCH)
                   + 2.0 * L_HEAD * D * BATCH) / F32_FLOP_PER_S]))
    del got, want, xg

    # -- matmul: one parity block's encode R_b @ W --------------------------
    a = ref.counter_parity_rows_ref(key, scale, ctrs_t, cols)
    got = ops.matmul(a, w)
    want = ref.matmul_ref(a, w)
    M, K, N = 256, L_HEAD, D
    report("matmul", "src/repro_torch/csrc/matmul.cu",
           "src/repro/kernels/matmul.py:38",
           max_err(got, want), 2e-3 * (1 + float(want.abs().max())),
           time_ms(lambda: ops.matmul(a, w)),
           time_ms(lambda: ref.matmul_ref(a, w)),
           time_ms(lambda: torch.matmul(a, w)),
           bound(4.0 * (M * K + K * N + M * N),
                 [2.0 * M * N * K / F32_FLOP_PER_S]))
    del a, w, got, want
    torch.cuda.empty_cache()
    return rows


def phase_d(dev) -> None:
    """Uncoded serving of llama3.2-1b at its published widths."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    cfg, params = serve.build_model(ARCH, smoke=False, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"[d] {cfg.name}: d_model {cfg.d_model}, {cfg.n_repeats} layers, "
          f"vocab {cfg.vocab}, {cfg.dtype}; init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    B, P, G = 4, 32, 16
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(B, P))).to(dev)
    serve.generate(cfg, params, prompts, 2)                  # warm-up
    toks, t_pre, t_dec = serve.generate(cfg, params, prompts, G)
    assert toks.shape == (B, G) and (toks >= 0).all() \
        and (toks < cfg.vocab).all()
    print(f"[d] uncoded serve {B} x prompt {P} x gen {G}: prefill "
          f"{B * P / t_pre:.1f} tok/s ({t_pre * 1e3:.1f} ms), decode "
          f"{B * (G - 1) / t_dec:.1f} tok/s ({t_dec * 1e3:.1f} ms)",
          flush=True)
    serve._MODEL_CACHE.clear()
    del params
    torch.cuda.empty_cache()


def _frozen_solve_sizes(bridge) -> list:
    L = bridge.head.L
    return [int((e.plans["head"].rows >= L).sum())
            for e in bridge._plan_cache._entries.values() if e.plans]


def phase_e(dev) -> None:
    """Coded serving of llama3.2-1b at its published widths."""
    import torch
    from repro_torch import kernels
    from repro_torch.obs import Tracer
    from repro_torch.serve_coded import CodedServingBridge, synthetic_requests
    from repro_torch.stream import AdmissionConfig
    before = kernels.launch_counts()
    # traced: device spans synchronise, so the per-stage wall is honest
    tracer = Tracer(meta={"entry": "chip_smoke", "phase": "e"})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    bridge = CodedServingBridge(
        masters=1, arch=ARCH, smoke=False, seed=CODED_SEED,
        slots_per_master=CODED_SLOTS, backend="torch",
        parity_storage="virtual", device_products=True, verify=True,
        admission=AdmissionConfig(policy="edf"), tracer=tracer, device=dev)
    bridge._setup_model(CODED_PROMPT + CODED_GEN + 8)
    print(f"[e] coded head L={bridge.head.L} D={bridge.head.D}, seed "
          f"{CODED_SEED}; setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    reqs = synthetic_requests(CODED_REQUESTS, masters=1,
                              vocab=bridge._model["cfg"].vocab,
                              prompt_len=CODED_PROMPT, gen_len=CODED_GEN,
                              rate=0.004, seed=CODED_SEED)
    rep = bridge.serve(reqs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    sizes = _frozen_solve_sizes(bridge)
    after = kernels.launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    print(f"[e] frozen-plan decode-solve sizes s={sizes}, solve steps "
          f"{rep.solve_steps}/{len(rep.steps)}, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[e] wall {rep.wall_seconds:.2f} s, {rep.tokens_generated} tokens "
          f"({rep.tokens_generated / rep.wall_seconds:.2f} tok/s), "
          f"max_err {rep.max_err:.3e}, argmax match "
          f"{rep.argmax_match_rate:.4f}, decode_ok(head tol) "
          f"{rep.decode_ok}; launches {grew}", flush=True)
    stages = {k: round(v, 3) for k, v in rep.per_stage_wall.items()}
    steps = [round(sp.dur, 3) for sp in tracer.spans
             if sp.cat == "step" and sp.name.startswith("step:")]
    print(f"[e] per-stage wall s {stages}; step walls s {steps} (the first "
          f"builds and factors the decode minor)", flush=True)
    answered = {rid: len(t) for rid, t in rep.tokens.items()}
    if len(answered) != CODED_REQUESTS or \
            any(n != CODED_GEN for n in answered.values()):
        raise AssertionError(f"not every request was answered: {answered}")
    if not sizes or not all(s > 0 for s in sizes):
        raise AssertionError(f"seed {CODED_SEED} gave no parity solve")
    for k in ("coded_matvec", "gen_parity_matvec", "counter_parity_rows"):
        if grew[k] <= 0:
            raise AssertionError(f"phase e never launched {k}")
    del bridge
    torch.cuda.empty_cache()


def phase_f(dev) -> None:
    """Coded serving at smoke size through serve_policy_sweep."""
    from repro_torch import kernels
    from repro_torch.serve_coded import (CodedServingBridge,
                                         serve_policy_sweep,
                                         synthetic_requests)
    for storage in ("materialized", "virtual"):
        before = kernels.launch_counts()
        bridge = CodedServingBridge(
            masters=2, arch=ARCH, smoke=True, seed=0, backend="torch",
            parity_storage=storage, device_products=True, verify=True,
            slots_per_master=2, device=dev)
        bridge._setup_model(16 + 4 + 8)
        reqs = synthetic_requests(6, masters=2,
                                  vocab=bridge._model["cfg"].vocab,
                                  prompt_len=16, gen_len=4, rate=0.02,
                                  seed=0)
        rep = serve_policy_sweep(bridge, reqs, ("edf",))["edf"]
        after = kernels.launch_counts()
        print(f"[f] smoke {storage}: decode_ok {rep.decode_ok}, max_err "
              f"{rep.max_err:.3e}, solve steps {rep.solve_steps}/"
              f"{len(rep.steps)}, launches "
              f"{ {k: after[k] - before[k] for k in after} }", flush=True)
        if rep.solve_steps == 0:
            raise AssertionError(f"smoke {storage}: no parity solve ran")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import _build
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    print(card_line(), flush=True)        # name, power limit, as nvidia-smi
    print(f"[a] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[b] built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(per source, from the start: "
          f"{ {k: round(v, 1) for k, v in built.items()} })", flush=True)
    for name in _build.SOURCES:
        log = (_build.BUILD / f"{name}.log").read_text().splitlines()
        regs = [ln.strip() for ln in log if "registers" in ln]
        print(f"[b] {name}: {regs[:3]}", flush=True)

    rows = phase_c(dev)
    phase_d(dev)
    kernels.reset_launch_counts()
    phase_e(dev)
    phase_f(dev)
    launches = kernels.launch_counts()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
        rows[name]["launches"] = n
    print(f"[g] total {time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys}
                                  for n in ("matmul", "coded_matvec",
                                            "counter_parity_rows",
                                            "gen_parity_matvec")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
