#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (``repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each prints what is worth keeping; any failure raises and the run
exits non-zero):

  a. the card: ``nvidia-smi`` name and power limit;
  b. build: every CUDA source in ``src/repro_torch/csrc`` compiled for
     sm_90a, one ``nvcc`` per source, all started together;
  c. each kernel against its plain-torch version at the shapes its path
     gives it -- the coded-serving shapes of llama3.2-1b (L = 128 512 head
     rows, D = 2048; the decode-feeding products in their float64-output
     form, beside the float32 one; the decode's known term R[par, known]
     @ y at seed 1's step, also against the two-pass path it replaces,
     and the counter rows at one chunk of it) and the paper's executor /
     streaming verify shapes (L = 1e4 rows per master, float64), and the
     RWKV-6 WKV recurrence at rwkv6-7b's serving prefill, decode and
     long-prefill shapes in bf16 and float32 (its launch plan printed,
     timed also from a CUDA graph beside a one-element kernel, 16 long
     prefills bit-equal; against the sequential oracle at strong decays
     and below the 1e-12 clamp in both types; at edge shapes) -- with
     its time (CUDA events, median), the plain version's time, a one-call
     PyTorch yardstick where one exists (for ``mds_encode`` also the same
     work: the parity rows alone), and the least time the card could take
     (bytes over HBM rate, or operations over the peak of their type), and
     where the wrapper's host work is not small beside the kernel, the
     time of calls queued back to back; the launch plan (tiles, grid, K
     slabs; coded_matvec's route, grid and rows a block) of each shape;
     the SM clock and power beside ``matmul`` and its library call; the
     GEMM kernels and ``coded_matvec`` against their plain versions at
     ragged, unaligned and split-K edge shapes, and repeated calls of
     each at its main shapes bit-equal; ``coded_matvec`` at
     deepseek-v3-671b's head tiles (L = 129 536, K = 7 168, C = 4) and
     the parity kernels at phase n's frozen DeepSeek solve;
  d. uncoded serving of llama3.2-1b at its published widths (bf16):
     prefill and decode tokens/s;
  e. coded serving of llama3.2-1b at its published widths: head scope,
     batched engine, virtual parity, device products (float64 sums),
     ``"torch"`` backend, one master: first seed 1 with float32 products
     (the reference's numerics, a measurement only), then four seeds whose
     frozen prefix needs a parity solve (seed 1 and the three largest
     solves of seeds 2-9); per seed the solve size, peak memory, wall
     time, max_err and the argmax match rate against the uncoded head,
     raising unless ``decode_ok`` holds at the bridge's 5e-4 head
     tolerance, and the decode's split (known term, minor build, LU
     factor, LU solve) from the trace;
  f. coded serving at smoke size, materialised and virtual parity, through
     ``serve_policy_sweep`` (which asserts ``decode_ok``);
  g. the paper's static coded executor at its size (§V-A: M = 4 masters,
     N = 50 workers, L = 1e4 rows each, task matrices 1e4 x 1e4, worker 7
     dead), ``backend="torch"``: completion and prefix per master, max_err,
     the wall split (host set-up, encode, products, decode) and peak
     memory; raises unless every master decodes at 1e-6;
  h. the streaming engine on the same scenario, 200 tasks with a degrade
     and a leave, ``numerics="verify"`` on ``"torch"``: raises unless every
     task decodes and the delay metrics equal its ``numerics="none"`` twin;
  j. uncoded serving of rwkv6-7b at its published widths (bf16, depth not
     cut): 4 x prompt 32 x gen 16 and 1 x prompt 4096 x gen 4, prefill and
     decode tokens/s and peak memory, gated on prefill + decode logits
     against the full forward over the same tokens;
  k. coded head serving of rwkv6-7b at its published widths, as phase e
     (L = 65 536 head rows, D = 4096) on seed 1 and the largest frozen
     parity solve of seeds 2-9, raising unless ``decode_ok`` holds at the
     5e-4 head tolerance and the argmax match is 1.0;
  l. coded serving of llama3.2-1b in trunk scope at its published widths
     (seed from a weightless probe of the frozen plans, ``plan_probe``),
     gated on the uncoded twin's tokens; a faulted serve at 2 layers;
  m. the paper's Monte Carlo on the card against numpy;
  n. the remaining mixers at their published widths, each model from a
     clean card: deepseek-v3-671b (MLA, MoE, MTP; cut to 2 layers),
     jamba-1.5-large-398b (attention, Mamba, MoE; 3 layers),
     gemma3-12b (sliding-window rings; full depth, a 1 536-token prompt
     that wraps them), dbrx-132b (MoE; 4 layers), internvl2-26b (vision
     frontend) and seamless-m4t-large-v2 (encoder-decoder): init, the
     frontend forward (``mtp_logits``, patches, frames), prefill + decode
     against the full forward at phase j's gate (MoE uncapped), an
     uncoded serve 4 x 32 x 16, and the head probe's parity rows; then
     deepseek-v3-671b served with a coded head (virtual parity, the first
     seed of 0-7 whose frozen head solve's float64 minor is under 30
     GiB), gated at the 5e-4 head tolerance, argmax 1.0 and tokens equal
     to its uncoded twin's;
  i. one JSON line with every kernel's numbers and its launches on the
     main path (phases e to n, counts reset just before e), then the
     result line.

Phases j to n start from a clean card (every model and bridge released)
and print the memory still allocated.

Exits non-zero without a result when no CUDA device is visible, or when
the repository's ``src`` is not beside this script.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published peaks of one H100 SXM (NVIDIA data sheet / Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12            # outside the tensor cores
TF32_FLOP_PER_S = 495e12          # TF32 tensor cores
F64_FLOP_PER_S = 67e12            # FP64 tensor cores (34e12 outside them)
INT32_OP_PER_S = 33.5e12          # white paper's INT32 figure
#: integer operations a counter-derived parity entry needs: two threefry
#: calls of 2 (round 1's add and xor) + 19 x 3 (add, rotation, xor) + 5 x
#: 2 key injections, and four >> 8 shifts.  The counters' key adds, the
#: column doubling and round 1's rotation depend on the row or the column
#: alone and are shared by the entries of a row or a column.  No per-pipe
#: term: only the 40 xors must run on the ALU pipe (half the INT32 rate),
#: under half of 142; an add can run as an IMAD, a rotation as an
#: IMAD.WIDE by 2^r whose halves the next xor's LOP3 takes in.
INT_OPS_PER_ENTRY = 2 * (2 + 19 * 3 + 5 * 2) + 4
#: float32 operations per entry: four scalings, three adds, the -2, x scale
F32_OPS_PER_ENTRY = 9

ARCH = "llama3.2-1b"
#: phase e's seeds: each one's first (and frozen) covering prefix needs a
#: parity solve (phase e prints the sizes; seed 1's is 48 876 rows, the
#: phase-c lane count).  Beside seed 1 they are the three largest frozen
#: solves among seeds 2-9 (s = 88 694, 79 636 and 61 967), chosen by solve
#: size alone; seed 2's float64 minor alone is 58.6 GiB.
CODED_SEEDS = (1, 2, 4, 8)
CODED_REQUESTS, CODED_PROMPT, CODED_GEN, CODED_SLOTS = 4, 16, 4, 4
#: the phase-c shapes: the packed head tiles of one step (128 512 rows
#: in 1004 tiles of 128), the step batch, phase e's parity lanes
TILES, TILE, D, BATCH = 1004, 128, 2048, CODED_SLOTS
L_HEAD = 128512
GEN_LANES = 48876
#: seed 1's known columns at its frozen solve (L_HEAD - GEN_LANES): the
#: decode's substitution term R[par, known] @ y is GEN_LANES x DECODE_KNOWN
DECODE_KNOWN = L_HEAD - GEN_LANES
#: the paper's size (core/problem.py large_scale_scenario, §V-A): rows per
#: master, and the task width S = L (the paper fixes L, not the width)
L_PAPER = 10_000
EXEC_DEAD = (7,)                  # the quickstart's straggler
STREAM_TASKS = 200
#: phase m's trial counts: the card's sampler and the numpy stream
MC_TORCH_TRIALS, MC_NUMPY_TRIALS = 1_000_000, 100_000
#: phase c's verify-path width: tasks per master in phase h (~200 / 4)
VERIFY_TASKS = 50

#: phase c's trunk shapes (phase l's packed stages of llama3.2-1b, one
#: layer): rows of each stage's prefix (the sum of its matmuls' L) and
#: the contraction width K, at the decode batch and at a prefill
TRUNK_STAGES = {"q/k/v": (2048 + 512 + 512, 2048), "o": (2048, 2048),
                "up/gate": (2 * 8192, 2048), "down": (2048, 8192)}
TRUNK_COLS = (4, 32)
#: phase c's trunk decode shapes (L, parity rows s): the known term
#: R[par, known] @ y of a trunk key's frozen solve, s x (L - s); sizes of
#: the 16-layer serve's probe at seed 0 (o: 635 of 2048; up: 4990 of
#: 8192)
TRUNK_DECODES = ((2048, 635), (8192, 4990))

RWKV = "rwkv6-7b"
#: phase j's runs (batch, prompt, generated tokens): the serving shape of
#: phase d, and one long prompt -- RWKV's use case, its state is constant
RWKV_RUNS = ((4, 32, 16), (1, 4096, 4))
#: phase j's gate, relative to 1 + max |logit|: prefill + decode against
#: the full forward at the last position.  bf16 activations (unit roundoff
#: 2^-9) are rounded again at every residual add, norm and matmul output
#: over 32 layers, and the two runs multiply matrices of different shapes
#: (T - 1 and 1 rows against T), hence in other accumulation orders; a
#: wrong state hand-off moves logits by their own size.
RWKV_LOGIT_TOL = 5e-2
#: phase k's seeds: seed 1, and the largest frozen parity solve of seeds
#: 2-9 at L = 65 536, chosen by solve size alone (phase k prints the
#: sizes: 24 924 and 45 230) from a probe of the bridge's frozen plans
#: that computed no product; a plan depends on L, the pool, the arrivals
#: and the delays, not on the weights.
RWKV_CODED_SEEDS = (1, 2)
#: phase n's models: (arch, the depth cut as dataclass fields or None for
#: the published depth, why); widths are never cut
DEEPSEEK = "deepseek-v3-671b"
MIXER_MODELS = (
    (DEEPSEEK, dict(prefix=1, n_repeats=1),
     "61 -> 2 layers (1 dense prefix + 1 MoE layer): the full model is "
     "1.3 TB"),
    ("jamba-1.5-large-398b", dict(block=3, n_repeats=1),
     "72 -> 3 layers (the block's attn + swiglu, mamba + moe, mamba + "
     "swiglu): the full model is 0.8 TB"),
    ("gemma3-12b", None, "not cut"),
    ("dbrx-132b", dict(n_repeats=4),
     "40 -> 4 layers: the full model is 0.26 TB"),
    ("internvl2-26b", None, "not cut"),
    ("seamless-m4t-large-v2", None, "not cut"),
)
#: phase n's uncoded serve (batch, prompt, generated tokens), as phase d's
MIXER_SERVE = (4, 32, 16)
#: phase n's decode gate (batch, prompt, decode steps) against the full
#: forward over prompt + steps tokens; gemma3's prompt wraps its 1 024-slot
#: rings
MIXER_GATE = {"gemma3-12b": (1, 1536, 16)}
MIXER_GATE_DEFAULT = (4, 32, 3)
#: phase n's DeepSeek seed: the first of these whose frozen head plan
#: (``plan_probe``, head scope) needs a float64 minor under the limit
MIXER_SEEDS = range(8)
MINOR_LIMIT_GIB = 30.0

#: phase c's WKV shapes (B, H, T): rwkv6-7b's 64 heads of 64
WKV_H, WKV_K = 64, 64
WKV_SHAPES = {"serving prefill": (4, 32), "decode": (4, 1),
              "long prefill": (1, 4096)}


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


def time_queued_ms(fn, iters: int = 20) -> float:
    """CUDA-event time of ``iters`` back-to-back calls of ``fn`` over
    ``iters`` (one warm-up call first): the device time per call once the
    host's launch work overlaps the previous call's kernels."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def time_graph_ms(fn, n: int = 20) -> float:
    """Device time a call of ``fn``: ``n`` calls captured in one CUDA
    graph and replayed (one warm-up replay first), so no host work sits
    between the kernels."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


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


def parity_op_times(ents: int) -> list:
    """Least seconds for ``ents`` counter-derived parity entries, by
    operation type: the integer operations at the INT32 rate, the float32
    ones at the FP32 rate."""
    return [ents * INT_OPS_PER_ENTRY / INT32_OP_PER_S,
            ents * F32_OPS_PER_ENTRY / F32_FLOP_PER_S]


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_c(dev, deepseek_s: int) -> dict:
    """Each kernel against its plain version at its path's shapes."""
    import numpy as np
    import torch
    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, source, replaces, err, tol, ms, plain_ms, lib_ms,
               bnd, **extra):
        ok = err <= tol
        print(f"[c] {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
              f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]})"
              + "".join(f", {k} {v:.3f}" for k, v in extra.items()),
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err} > {tol})")
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bnd[0],
                          bound_by=bnd[1], library_ms=lib_ms, **extra)

    # -- coded_matvec: one step's packed head tiles against the batch -----
    # float32 tiles and activations; the serving default sums in float64
    # (the products feed the decode), float32 is the reference's numerics
    tiles = torch.randn((TILES, TILE, D), generator=gen, device=dev) * 0.02
    x = torch.randn((D, BATCH), generator=gen, device=dev)
    flat = tiles.reshape(-1, D)
    n = TILES * TILE
    f32_ms = time_ms(lambda: ops.coded_shard_matmul_batch(
        tiles, x, out_dtype=torch.float32))
    got32 = ops.coded_shard_matmul_batch(tiles, x, out_dtype=torch.float32)
    err32 = max_err(got32.reshape(-1, BATCH), ref.coded_matvec_ref(flat, x))
    print(f"[c] coded_matvec float32 output: {f32_ms:.3f} ms, max_abs_err "
          f"{err32:.3e} against its plain version", flush=True)
    got = ops.coded_shard_matmul_batch(tiles, x).reshape(-1, BATCH)
    want = ref.coded_matvec_ref(flat, x, out_dtype=torch.float64)
    print_matvec_plan("serving shape", flat, x)
    # the rows of a sum are fixed in order: every call gives the same bits
    repeat_equal("coded_matvec at the serving shape", got,
                 lambda: ops.coded_shard_matmul_batch(tiles, x).reshape(
                     -1, BATCH))
    report("coded_matvec", "src/repro_torch/csrc/coded_matvec.cu",
           "src/repro/kernels/coded_matvec.py:38",
           max_err(got, want), 1e-12 * (1 + float(want.abs().max())),
           time_ms(lambda: ops.coded_shard_matmul_batch(tiles, x)),
           time_ms(lambda: ref.coded_matvec_ref(flat, x,
                                                out_dtype=torch.float64)),
           time_ms(lambda: torch.matmul(flat, x)),
           bound(4.0 * (n * D + D * BATCH) + 8.0 * n * BATCH,
                 [2.0 * n * D * BATCH / F64_FLOP_PER_S]),
           queued_ms=time_queued_ms(
               lambda: ops.coded_shard_matmul_batch(tiles, x)),
           library_queued_ms=time_queued_ms(lambda: torch.matmul(flat, x)))
    del tiles, flat, got, want, got32
    rows["coded_matvec"]["trunk"] = trunk_matvec_rows(dev, gen)

    # -- coded_matvec, batched: the executor's 4 x (2L x L) . (L,) float64 -
    B4, Lp = 4, L_PAPER
    at = torch.randn((B4, 2 * Lp, Lp), generator=gen, device=dev,
                     dtype=torch.float64)
    xb = torch.randn((B4, Lp), generator=gen, device=dev,
                     dtype=torch.float64)
    got = ops.coded_matvec_batch(at, xb)
    want = ref.coded_matvec_batch_ref(at, xb)
    err = max_err(got, want)
    tol = 1e-12 * (1 + float(want.abs().max()))
    print_matvec_plan("batched executor shape", at, xb[..., None])
    repeat_equal("batched coded_matvec", got,
                 lambda: ops.coded_matvec_batch(at, xb))
    ms = time_ms(lambda: ops.coded_matvec_batch(at, xb))
    plain_ms = time_ms(lambda: ref.coded_matvec_batch_ref(at, xb))
    lib_ms = time_ms(lambda: torch.matmul(at, xb[..., None]))
    # queued back to back: the device time a call once the wrapper's host
    # work overlaps the previous call's kernel; single minus queued is the
    # host work a call
    q_ms = time_queued_ms(lambda: ops.coded_matvec_batch(at, xb))
    q_lib_ms = time_queued_ms(lambda: torch.matmul(at, xb[..., None]))
    bnd = bound(8.0 * (B4 * 2 * Lp * Lp + B4 * Lp + B4 * 2 * Lp),
                [2.0 * B4 * 2 * Lp * Lp / F64_FLOP_PER_S])
    print(f"[c] coded_matvec batched 4 x ({2 * Lp} x {Lp}) . ({Lp},) "
          f"float64: max_abs_err={err:.3e} (tol {tol:.3e}) kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
          f"bound {bnd[0]:.3f} ms ({bnd[1]}); queued back to back: kernel "
          f"{q_ms:.3f} ms, library {q_lib_ms:.3f} ms; host work a call: "
          f"kernel {(ms - q_ms) * 1e3:.1f} us, library "
          f"{(lib_ms - q_lib_ms) * 1e3:.1f} us", flush=True)
    if err > tol:
        raise AssertionError(f"batched coded_matvec disagrees ({err})")
    rows["coded_matvec"]["batched"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd[0],
        max_abs_err=err, queued_ms=q_ms, library_queued_ms=q_lib_ms)
    # wider than one 8-column chunk: one counted launch per chunk
    from repro_torch.kernels import coded_matvec as cmv
    a12 = at[0, :4096]
    x12 = torch.randn((Lp, 12), generator=gen, device=dev,
                      dtype=torch.float64)
    n0 = cmv.LAUNCHES
    got = cmv.coded_matvec_cuda(a12, x12)
    err12 = max_err(got, ref.coded_matvec_ref(a12, x12))
    print(f"[c] coded_matvec 12 columns: {cmv.LAUNCHES - n0} launches, "
          f"max_abs_err={err12:.3e}", flush=True)
    if cmv.LAUNCHES - n0 != 2 or err12 > tol:
        raise AssertionError("coded_matvec over two column chunks")
    del at, xb, got, want, a12, x12
    torch.cuda.empty_cache()
    coded_matvec_edge_sweep(dev)

    # -- mds_encode: the executor's 4 x parity (L x L) @ (L x L) float64 ----
    sq = float(np.sqrt(Lp))
    G = torch.randn((B4, 2 * Lp, Lp), generator=gen, device=dev,
                    dtype=torch.float64) / sq
    G[:, :Lp] = torch.eye(Lp, dtype=torch.float64, device=dev)
    A = torch.randn((B4, Lp, Lp), generator=gen, device=dev,
                    dtype=torch.float64)

    def plain_enc(g, a):
        """The wrapper's plain version: prefix copied, parity multiplied."""
        return torch.cat([a, ref.mds_encode_ref(g[..., Lp:, :], a)],
                         dim=-2)

    for dt in (torch.float32, torch.float64):
        g, a = G.to(dt), A.to(dt)
        got = ops.mds_encode_batch(g, a)
        want = plain_enc(g, a)
        if not torch.equal(got[:, :Lp], a):
            raise AssertionError(f"mds_encode {dt}: the systematic prefix "
                                 f"is not A bit for bit")
        err = max_err(got, want)
        # float32: the reference's kernel tolerance; float64: sums of 1e4
        # exact-order FMAs in another order
        tol = (1e-12 if dt == torch.float64 else 2e-3) \
            * (1 + float(want.abs().max()))
        del got, want
        esz = 8.0 if dt == torch.float64 else 4.0
        bnd = bound(esz * (B4 * Lp * Lp + B4 * Lp * Lp + B4 * 2 * Lp * Lp),
                    [2.0 * B4 * Lp * Lp * Lp
                     / (F64_FLOP_PER_S if dt == torch.float64
                        else F32_FLOP_PER_S)])
        ms = time_ms(lambda: ops.mds_encode_batch(g, a), 3)
        plain_ms = time_ms(lambda: plain_enc(g, a), 3)
        lib_ms = time_ms(lambda: torch.matmul(g, a), 3)
        # the same work as the kernel: the parity rows only
        par_ms = time_ms(lambda: torch.matmul(g[:, Lp:], a), 3)
        print_plan(f"mds_encode {str(dt).split('.')[-1]} executor shape",
                   "f64" if dt == torch.float64 else "f32", Lp, Lp, Lp, B4)
        if dt == torch.float64:
            report("mds_encode", "src/repro_torch/csrc/mds_encode_gemm.cu",
                   "src/repro/kernels/mds_encode.py:38", err, tol, ms,
                   plain_ms, lib_ms, bnd, library_parity_ms=par_ms)
        else:
            print(f"[c] mds_encode float32 at the executor's shape: "
                  f"max_abs_err={err:.3e} (tol {tol:.3e}) kernel {ms:.3f} "
                  f"ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
                  f"library on the parity rows {par_ms:.3f} ms, bound "
                  f"{bnd[0]:.3f} ms ({bnd[1]})", flush=True)
            if err > tol:
                raise AssertionError(f"mds_encode float32 disagrees ({err})")
            f32_row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           library_parity_ms=par_ms, bound_ms=bnd[0],
                           max_abs_err=err)
        del g, a
    rows["mds_encode"]["float32"] = f32_row
    del A
    torch.cuda.empty_cache()

    # -- mds_encode: the verify path's skinny (2L x L) @ (L x tasks) --------
    g = G[0].contiguous()
    del G
    zt = torch.randn((Lp, VERIFY_TASKS), generator=gen, device=dev,
                     dtype=torch.float64)
    got = ops.mds_encode(g, zt)
    want = plain_enc(g, zt)
    err = max_err(got, want)
    tol = 1e-12 * (1 + float(want.abs().max()))
    ms = time_ms(lambda: ops.mds_encode(g, zt))
    plain_ms = time_ms(lambda: plain_enc(g, zt))
    lib_ms = time_ms(lambda: torch.matmul(g, zt))
    par_ms = time_ms(lambda: torch.matmul(g[Lp:], zt))
    bnd = bound(8.0 * (Lp * Lp + Lp * VERIFY_TASKS
                       + 2 * Lp * VERIFY_TASKS),
                [2.0 * Lp * Lp * VERIFY_TASKS / F64_FLOP_PER_S])
    # at this size the wrapper's host work (plan, two allocations, three
    # launches) is not small beside the kernels: also time calls queued
    # back to back, which hides it behind the previous call's kernels
    q_ms = time_queued_ms(lambda: ops.mds_encode(g, zt))
    q_par_ms = time_queued_ms(lambda: torch.matmul(g[Lp:], zt))
    print_plan("mds_encode float64 verify shape", "f64", Lp, VERIFY_TASKS,
               Lp)
    print(f"[c] mds_encode float64 at the verify shape ({2 * Lp} x {Lp}) @ "
          f"({Lp} x {VERIFY_TASKS}): max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.3f} ms, library on the parity rows {par_ms:.3f} ms, "
          f"bound {bnd[0]:.3f} ms ({bnd[1]}); queued back to back: kernel "
          f"{q_ms:.3f} ms, library on the parity rows {q_par_ms:.3f} ms",
          flush=True)
    rows["mds_encode"]["verify"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_parity_ms=par_ms, bound_ms=bnd[0], max_abs_err=err,
        queued_ms=q_ms, library_parity_queued_ms=q_par_ms)
    if err > tol or not torch.equal(got[:Lp], zt):
        raise AssertionError(f"mds_encode at the verify shape disagrees "
                             f"({err})")
    # split K is summed in a fixed order and the ring is handed over by
    # mbarriers: every call must give the same bits
    if not all(torch.equal(got, ops.mds_encode(g, zt)) for _ in range(16)):
        raise AssertionError("mds_encode at the verify shape is not bitwise "
                             "repeatable")
    del g, zt, got, want
    torch.cuda.empty_cache()

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
    # timed on device counters of the kernel's operand type (uint32 bits
    # as int32), as the decode holds them
    kc = torch.from_numpy(ctrs.view(np.int32)).to(dev)
    report("counter_parity_rows", "src/repro_torch/csrc/mds_encode.cu",
           "src/repro/kernels/mds_encode.py:65", max_err(got, want), 0.0,
           time_ms(lambda: ops.counter_parity_rows(key, L_HEAD, kc)),
           time_ms(lambda: ref.counter_parity_rows_ref(key, scale, ctrs_t,
                                                       cols), 3),
           None,
           bound(4.0 * (ents + 256 + L_HEAD), parity_op_times(ents)),
           queued_ms=time_queued_ms(lambda: ops.counter_parity_rows(
               key, L_HEAD, kc)))
    del got, want

    # -- the decode's parity operands at seed 1's step (phase e): 48 876
    # parity rows against the 79 636 known columns, C = 4 slots.  Its
    # minor build derives R[par, unk] in row chunks of DECODE_CHUNK
    # entries (counter_parity_rows; timed here at such a chunk of the
    # known columns, which the two-pass path below runs); every step
    # contracts R[par, known] against the pinned values
    # (parity_contract), R never in memory
    from repro_torch.serve_coded.packing import DECODE_CHUNK
    rng = np.random.default_rng(0)
    dctrs = mds.parity_counters(np.arange(GEN_LANES), 0)
    dcols = np.sort(rng.permutation(L_HEAD)[:DECODE_KNOWN])
    dctrs_t = torch.from_numpy(dctrs.astype(np.int64)).to(dev)
    dcols_t = torch.from_numpy(dcols).to(dev)
    kc = torch.from_numpy(dctrs.view(np.int32)).to(dev)     # uint32 bits,
    kj = dcols_t.to(torch.int32)                            # as the decode
    chunk = DECODE_CHUNK // DECODE_KNOWN                    # holds them
    got = ops.counter_parity_rows(key, L_HEAD, kc[:chunk], cols=kj)
    plain_ms, want = time_once(lambda: ref.counter_parity_rows_ref(
        key, scale, dctrs_t[:chunk], dcols_t))
    host = mds.counter_parity_rows(key, dctrs[:4], L_HEAD,
                                   dtype=np.float32)[:, dcols]
    if not (torch.equal(got, want)
            and np.array_equal(got[:4].cpu().numpy(), host)):
        raise AssertionError("counter_parity_rows at the decode chunk is "
                             "not bit-equal")
    ents = chunk * DECODE_KNOWN
    bnd = bound(4.0 * (ents + chunk + DECODE_KNOWN), parity_op_times(ents))
    rows_chunk = dict(
        ms=time_ms(lambda: ops.counter_parity_rows(key, L_HEAD, kc[:chunk],
                                                   cols=kj)),
        queued_ms=time_queued_ms(lambda: ops.counter_parity_rows(
            key, L_HEAD, kc[:chunk], cols=kj)),
        plain_ms=plain_ms, bound_ms=bnd[0], max_abs_err=0.0)
    rows["counter_parity_rows"]["decode_chunk"] = rows_chunk
    print(f"[c] counter_parity_rows at the decode chunk {chunk} x "
          f"{DECODE_KNOWN} gathered: bit-equal; kernel "
          f"{rows_chunk['ms']:.3f} ms, queued {rows_chunk['queued_ms']:.3f}"
          f" ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]})",
          flush=True)
    del got, want

    y = torch.randn((DECODE_KNOWN, BATCH), generator=gen, device=dev,
                    dtype=torch.float64)

    def two_pass():
        """The known term in two passes, the contraction's yardstick:
        counter-row chunks of DECODE_CHUNK entries, a float64 cast,
        torch.matmul."""
        out = torch.empty((GEN_LANES, BATCH), dtype=torch.float64,
                          device=dev)
        for i in range(0, GEN_LANES, chunk):
            out[i:i + chunk] = ops.counter_parity_rows(
                key, L_HEAD, kc[i:i + chunk], cols=kj).to(torch.float64) @ y
        return out

    got = ops.parity_contract(key, L_HEAD, kc, y, cols=kj)
    plain_ms, want = time_once(lambda: ref.parity_contract_ref(
        key, scale, dctrs_t, dcols_t, y))
    tol = 1e-12 * (1 + float(want.abs().max()))
    two_ms, two = time_ms(two_pass, 3), two_pass()
    two_err = max_err(got, two)
    print(f"[c] parity_contract against the two-pass path (counter rows, "
          f"float64 cast, torch.matmul; {two_ms:.3f} ms): max_abs_err="
          f"{two_err:.3e} (tol {tol:.3e})", flush=True)
    if two_err > tol:
        raise AssertionError(f"parity_contract disagrees with the two-pass "
                             f"path ({two_err} > {tol})")
    # a fixed summation order and no atomics: every call the same bits
    repeat_equal("parity_contract at seed 1's step", got,
                 lambda: ops.parity_contract(key, L_HEAD, kc, y, cols=kj))
    ents = GEN_LANES * DECODE_KNOWN
    report("parity_contract", "src/repro_torch/csrc/mds_encode.cu",
           "src/repro/kernels/mds_encode.py:65", max_err(got, want), tol,
           time_ms(lambda: ops.parity_contract(key, L_HEAD, kc, y,
                                               cols=kj)),
           plain_ms, None,
           bound(4.0 * (GEN_LANES + DECODE_KNOWN)
                 + 8.0 * (DECODE_KNOWN + GEN_LANES) * BATCH,
                 parity_op_times(ents)
                 + [2.0 * ents * BATCH / F64_FLOP_PER_S]),
           queued_ms=time_queued_ms(lambda: ops.parity_contract(
               key, L_HEAD, kc, y, cols=kj)),
           two_pass_ms=two_ms)
    del got, want, two, y, kc, kj, dctrs_t, dcols_t
    torch.cuda.empty_cache()
    rows["parity_contract"]["trunk"] = trunk_contract_rows(dev, gen, key)
    (rows["coded_matvec"]["deepseek_head"],
     rows["counter_parity_rows"]["deepseek_chunk"],
     rows["parity_contract"]["deepseek_head"]) = \
        deepseek_head_rows(dev, gen, key, deepseek_s)

    # -- gen_parity_matvec: phase e's parity lanes against resident W ------
    w = torch.randn((L_HEAD, D), generator=gen, device=dev) * 0.02
    xg = torch.randn((D, BATCH), generator=gen, device=dev)
    gctrs = torch.from_numpy(
        mds.parity_counters(np.arange(GEN_LANES), 0).astype(np.int64)).to(dev)
    ents = GEN_LANES * L_HEAD
    got32 = ops.gen_parity_products(key, gctrs, w, xg,
                                    out_dtype=torch.float32)
    got = ops.gen_parity_products(key, gctrs, w, xg)
    plain_ms, want = time_once(
        lambda: ref.gen_parity_ref(key, scale, gctrs, w, xg,
                                   out_dtype=torch.float64))
    f32_ms = time_ms(lambda: ops.gen_parity_products(
        key, gctrs, w, xg, out_dtype=torch.float32))
    print(f"[c] gen_parity_matvec float32 output: {f32_ms:.3f} ms, "
          f"max_abs_err {max_err(got32, want):.3e} against the float64 "
          f"plain version", flush=True)
    report("gen_parity_matvec", "src/repro_torch/csrc/mds_encode.cu",
           "src/repro/kernels/mds_encode.py:116",
           max_err(got, want), 1e-12 * (1 + float(want.abs().max())),
           time_ms(lambda: ops.gen_parity_products(key, gctrs, w, xg)),
           plain_ms, None,
           bound(4.0 * (L_HEAD * D + D * BATCH + GEN_LANES)
                 + 8.0 * GEN_LANES * BATCH,
                 parity_op_times(ents)
                 + [(ents * 2 * BATCH + 2.0 * L_HEAD * D * BATCH)
                    / F64_FLOP_PER_S]))
    del got, got32, want, xg

    # -- matmul: one parity block's encode R_b @ W --------------------------
    a = ref.counter_parity_rows_ref(key, scale, ctrs_t, cols)
    got = ops.matmul(a, w)
    want = ref.matmul_ref(a, w)
    M, K, N = 256, L_HEAD, D
    print_plan("matmul serving shape", "f32", M, N, K)
    # split K is summed in a fixed order: every call gives the same bits
    repeat_equal("matmul at the serving shape", got, lambda: ops.matmul(a, w))
    ms = time_ms(lambda: ops.matmul(a, w))
    lib_ms = time_ms(lambda: torch.matmul(a, w))
    # an FFMA-dense kernel may run below the boost clock (the power limit),
    # and so may the library's: the SM clock and power over a second of
    # each, back to back
    clocks = {k: sample_clocks(f) for k, f in
              (("kernel", lambda: ops.matmul(a, w)),
               ("library", lambda: torch.matmul(a, w)))}
    print(f"[c] matmul clocks over 1 s of calls (nvidia-smi, every 100 ms): "
          + "; ".join(f"{k}: {v}" for k, v in clocks.items()), flush=True)
    report("matmul", "src/repro_torch/csrc/matmul.cu",
           "src/repro/kernels/matmul.py:38",
           max_err(got, want), 2e-3 * (1 + float(want.abs().max())), ms,
           time_ms(lambda: ref.matmul_ref(a, w)), lib_ms,
           bound(4.0 * (M * K + K * N + M * N),
                 [2.0 * M * N * K / F32_FLOP_PER_S]))
    del a, w, got, want
    torch.cuda.empty_cache()
    gemm_edge_sweep(dev)
    wkv6_extra = wkv6_rows(dev, report)
    rows["wkv6"].update(wkv6_extra)
    return rows


def trunk_matvec_rows(dev, gen) -> dict:
    """``coded_matvec`` at phase l's packed trunk stages (ragged stage
    rows in 128-row tiles, K up to 8192), float64 sums, against its plain
    version."""
    import torch
    from repro_torch.kernels import ops, ref
    out = {}
    for stage, (n, K) in TRUNK_STAGES.items():
        nt = -(-n // TILE)
        tiles = torch.randn((nt, TILE, K), generator=gen, device=dev) * 0.02
        flat = tiles.reshape(-1, K)
        for C in TRUNK_COLS:
            x = torch.randn((K, C), generator=gen, device=dev)
            got = ops.coded_shard_matmul_batch(tiles, x).reshape(-1, C)
            want = ref.coded_matvec_ref(flat, x, out_dtype=torch.float64)
            err = max_err(got, want)
            tol = 1e-12 * (1 + float(want.abs().max()))
            row = dict(
                ms=time_ms(lambda: ops.coded_shard_matmul_batch(tiles, x)),
                queued_ms=time_queued_ms(
                    lambda: ops.coded_shard_matmul_batch(tiles, x)),
                plain_ms=time_ms(lambda: ref.coded_matvec_ref(
                    flat, x, out_dtype=torch.float64)),
                library_ms=time_ms(lambda: torch.matmul(flat, x)),
                bound_ms=bound(4.0 * (nt * TILE * K + K * C)
                               + 8.0 * nt * TILE * C,
                               [2.0 * nt * TILE * K * C
                                / F64_FLOP_PER_S])[0],
                max_abs_err=err)
            print(f"[c] coded_matvec trunk {stage} ({n} rows in {nt} tiles,"
                  f" K {K}, C {C}): max_abs_err={err:.3e} (tol {tol:.3e})"
                  f" kernel {row['ms']:.4f} ms, queued "
                  f"{row['queued_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                  f"library {row['library_ms']:.4f}, bound "
                  f"{row['bound_ms']:.4f} ms", flush=True)
            if err > tol:
                raise AssertionError(f"coded_matvec at the trunk stage "
                                     f"{stage} disagrees ({err} > {tol})")
            out[f"{stage} C={C}"] = row
        del tiles, flat
    return out


def trunk_contract_rows(dev, gen, key) -> dict:
    """The decode's known term (``parity_contract``) at trunk keys'
    frozen solves, against its plain version."""
    import torch
    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref
    out = {}
    rng = np.random.default_rng(1)
    for L, s in TRUNK_DECODES:
        m = L - s
        ctrs = mds.parity_counters(np.arange(s), 0)
        cols = np.sort(rng.permutation(L)[:m])
        kc = torch.from_numpy(ctrs.view(np.int32)).to(dev)
        kj = torch.from_numpy(cols.astype(np.int32)).to(dev)
        ctrs_t = torch.from_numpy(ctrs.astype(np.int64)).to(dev)
        cols_t = torch.from_numpy(cols).to(dev)
        scale = ops.parity_scale(L)
        for C in TRUNK_COLS:
            y = torch.randn((m, C), generator=gen, device=dev,
                            dtype=torch.float64)
            got = ops.parity_contract(key, L, kc, y, cols=kj)
            want = ref.parity_contract_ref(key, scale, ctrs_t, cols_t, y)
            err = max_err(got, want)
            tol = 1e-12 * (1 + float(want.abs().max()))
            ents = s * m
            row = dict(
                ms=time_ms(lambda: ops.parity_contract(key, L, kc, y,
                                                       cols=kj)),
                queued_ms=time_queued_ms(lambda: ops.parity_contract(
                    key, L, kc, y, cols=kj)),
                plain_ms=time_ms(lambda: ref.parity_contract_ref(
                    key, scale, ctrs_t, cols_t, y), 3),
                bound_ms=bound(4.0 * (s + m) + 8.0 * (m + s) * C,
                               parity_op_times(ents)
                               + [2.0 * ents * C / F64_FLOP_PER_S])[0],
                max_abs_err=err)
            print(f"[c] parity_contract trunk L {L}, {s} parity rows x {m} "
                  f"known, C {C}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                  f"kernel {row['ms']:.4f} ms, queued "
                  f"{row['queued_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                  f"bound {row['bound_ms']:.4f} ms", flush=True)
            if err > tol:
                raise AssertionError(f"parity_contract at a trunk decode "
                                     f"disagrees ({err} > {tol})")
            out[f"L={L} s={s} C={C}"] = row
    return out


def deepseek_coded_seed() -> tuple:
    """(seed, head parity rows s) of phase n's coded DeepSeek serve: the
    first of MIXER_SEEDS whose frozen head plan needs a parity solve whose
    float64 minor (8 s^2 bytes) is under MINOR_LIMIT_GIB (``plan_probe``,
    head scope; only the head's height matters, so the published config
    is probed)."""
    from repro_torch.configs import get_config
    cfg = get_config(DEEPSEEK)
    sizes = {}
    for seed in MIXER_SEEDS:
        s = max(plan_probe(cfg, seed, scope="head")["head"])
        sizes[seed] = (s, round(8 * s * s / 2**30, 2))
        if 0 < s and 8 * s * s / 2**30 < MINOR_LIMIT_GIB:
            print(f"[n] {DEEPSEEK} head probe: seed -> (parity rows s, "
                  f"float64 minor GiB): {sizes}; chosen seed {seed}",
                  flush=True)
            return seed, s
    raise AssertionError(f"no seed's head minor fits: {sizes}")


def deepseek_head_rows(dev, gen, key, s: int) -> tuple:
    """Row 2d: ``coded_matvec`` at DeepSeek-V3's packed head tiles (L =
    129 536 rows in 1 012 tiles of 128, K = d_model 7 168, C = 4, float64
    sums); and the parity kernels at phase n's frozen solve, s parity rows
    against the L - s known columns: ``counter_parity_rows`` at one chunk
    of the minor build, ``parity_contract`` (the decode's known term, C =
    4) -- each against its plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref
    from repro_torch.models import padded_vocab
    from repro_torch.serve_coded.packing import DECODE_CHUNK
    cfg = get_config(DEEPSEEK)
    L, K = padded_vocab(cfg), cfg.d_model
    nt = -(-L // TILE)
    tiles = torch.randn((nt, TILE, K), generator=gen, device=dev) * 0.02
    flat = tiles.reshape(-1, K)
    x = torch.randn((K, BATCH), generator=gen, device=dev)
    got = ops.coded_shard_matmul_batch(tiles, x).reshape(-1, BATCH)
    want = ref.coded_matvec_ref(flat, x, out_dtype=torch.float64)
    err, tol = max_err(got, want), 1e-12 * (1 + float(want.abs().max()))
    print_matvec_plan("deepseek head", flat, x)
    mv = dict(
        ms=time_ms(lambda: ops.coded_shard_matmul_batch(tiles, x)),
        queued_ms=time_queued_ms(
            lambda: ops.coded_shard_matmul_batch(tiles, x)),
        plain_ms=time_ms(lambda: ref.coded_matvec_ref(
            flat, x, out_dtype=torch.float64)),
        library_ms=time_ms(lambda: torch.matmul(flat, x)),
        library_queued_ms=time_queued_ms(lambda: torch.matmul(flat, x)),
        bound_ms=bound(4.0 * (nt * TILE * K + K * BATCH)
                       + 8.0 * nt * TILE * BATCH,
                       [2.0 * nt * TILE * K * BATCH / F64_FLOP_PER_S])[0],
        max_abs_err=err)
    print(f"[c] coded_matvec at {DEEPSEEK}'s head ({nt} tiles of {TILE} x "
          f"K {K}, C {BATCH}, float64 sums; row 2d): max_abs_err={err:.3e} "
          f"(tol {tol:.3e}) kernel {mv['ms']:.4f} ms, queued "
          f"{mv['queued_ms']:.4f}, plain {mv['plain_ms']:.4f}, library "
          f"{mv['library_ms']:.4f} (queued {mv['library_queued_ms']:.4f}), "
          f"bound {mv['bound_ms']:.4f} ms", flush=True)
    if err > tol:
        raise AssertionError(f"coded_matvec at the DeepSeek head disagrees "
                             f"({err} > {tol})")
    del tiles, flat, got, want

    m = L - s
    ctrs = mds.parity_counters(np.arange(s), 0)
    cols = np.sort(np.random.default_rng(0).permutation(L)[:m])
    ctrs_t = torch.from_numpy(ctrs.astype(np.int64)).to(dev)
    cols_t = torch.from_numpy(cols).to(dev)
    kc = torch.from_numpy(ctrs.view(np.int32)).to(dev)
    kj = cols_t.to(torch.int32)
    scale = ops.parity_scale(L)
    chunk = DECODE_CHUNK // m
    got = ops.counter_parity_rows(key, L, kc[:chunk], cols=kj)
    plain_ms, want = time_once(lambda: ref.counter_parity_rows_ref(
        key, scale, ctrs_t[:chunk], cols_t))
    if not torch.equal(got, want):
        raise AssertionError("counter_parity_rows at the DeepSeek minor "
                             "chunk is not bit-equal")
    ents = chunk * m
    rows_chunk = dict(
        ms=time_ms(lambda: ops.counter_parity_rows(key, L, kc[:chunk],
                                                   cols=kj)),
        queued_ms=time_queued_ms(lambda: ops.counter_parity_rows(
            key, L, kc[:chunk], cols=kj)),
        plain_ms=plain_ms,
        bound_ms=bound(4.0 * (ents + chunk + m), parity_op_times(ents))[0],
        max_abs_err=0.0)
    print(f"[c] counter_parity_rows at {DEEPSEEK}'s minor chunk {chunk} x "
          f"{m} gathered (L {L}): bit-equal; kernel {rows_chunk['ms']:.3f} "
          f"ms, queued {rows_chunk['queued_ms']:.3f}, plain {plain_ms:.3f}, "
          f"bound {rows_chunk['bound_ms']:.3f} ms", flush=True)
    del got, want
    y = torch.randn((m, BATCH), generator=gen, device=dev,
                    dtype=torch.float64)
    got = ops.parity_contract(key, L, kc, y, cols=kj)
    plain_ms, want = time_once(lambda: ref.parity_contract_ref(
        key, scale, ctrs_t, cols_t, y))
    err, tol = max_err(got, want), 1e-12 * (1 + float(want.abs().max()))
    ents = s * m
    known = dict(
        ms=time_ms(lambda: ops.parity_contract(key, L, kc, y, cols=kj)),
        queued_ms=time_queued_ms(lambda: ops.parity_contract(
            key, L, kc, y, cols=kj)),
        plain_ms=plain_ms,
        bound_ms=bound(4.0 * (s + m) + 8.0 * (m + s) * BATCH,
                       parity_op_times(ents)
                       + [2.0 * ents * BATCH / F64_FLOP_PER_S])[0],
        max_abs_err=err)
    print(f"[c] parity_contract at {DEEPSEEK}'s known term, {s} parity rows "
          f"x {m} known, C {BATCH}: max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel {known['ms']:.3f} ms, queued {known['queued_ms']:.3f}, "
          f"plain {plain_ms:.1f}, bound {known['bound_ms']:.3f} ms",
          flush=True)
    if err > tol:
        raise AssertionError(f"parity_contract at the DeepSeek known term "
                             f"disagrees ({err} > {tol})")
    del got, want, y, kc, kj, ctrs_t, cols_t
    torch.cuda.empty_cache()
    return mv, rows_chunk, known


def repeat_equal(label: str, first, fn, times: int = 16) -> None:
    """Raise unless ``times`` more calls of ``fn`` give ``first`` bit for
    bit."""
    import torch
    if not all(torch.equal(first, fn()) for _ in range(times)):
        raise AssertionError(f"{label} is not bitwise repeatable")


def sample_clocks(fn, seconds: float = 1.0) -> str:
    """Median SM clock and power draw that ``nvidia-smi`` samples every
    100 ms while ``fn`` runs back to back for ``seconds``."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    proc.terminate()
    out, _ = proc.communicate()
    samples = []
    for line in out.splitlines():
        parts = [v.strip() for v in line.split(",")]
        try:
            samples.append((float(parts[0]), float(parts[1])))
        except (ValueError, IndexError):
            continue
    if not samples:
        return "not measured (no samples)"
    mhz = sorted(m for m, _ in samples)
    watts = sorted(w for _, w in samples)
    return (f"sm {mhz[len(mhz) // 2]:.0f} MHz (range {mhz[0]:.0f}-"
            f"{mhz[-1]:.0f}), power {watts[len(watts) // 2]:.0f} W, "
            f"{len(samples)} samples")


def print_matvec_plan(label: str, a, x) -> None:
    """The launch plan of each 8-column chunk coded_matvec runs for ``a``
    (R, K) or (B, R, K) against ``x`` (K, C) or (B, K, C)."""
    import torch
    from repro_torch.kernels.plan import MV_COLS, matvec_plan
    B = a.shape[0] if a.dim() == 3 else 1
    R, K = a.shape[-2:]
    C = x.shape[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c0 in range(0, C, MV_COLS):
        p = matvec_plan(a.element_size(), R, K, min(MV_COLS, C - c0), B,
                        sms)
        waves = p.blocks / (p.blocks_per_sm * sms)
        print(f"[c] plan coded_matvec {label} (columns {c0}-"
              f"{c0 + p.cc - 1}): {p.route}, grid {p.grid} = {p.blocks} "
              f"blocks of {p.threads} threads ({waves:.2f} waves of "
              f"{p.blocks_per_sm} an SM), {p.rows_per_block} rows a block, "
              f"X slab {p.slab_bytes} B", flush=True)


#: phase c's coded_matvec edge shapes: (B, R, K, C) -- ragged R (not a
#: multiple of any block's rows), K of 2, 6 and 10 002 (padded to the
#: 16-byte vector as ops pads it), C across the 8-column chunks
MATVEC_EDGES = ((1, 1237, 2, 1), (4, 1237, 6, 3), (1, 4099, 10002, 1),
                (4, 777, 10002, 8), (1, 3001, 6, 9), (4, 555, 2, 12),
                (1, 20011, 10002, 3), (4, 1, 6, 1))


def coded_matvec_edge_sweep(dev) -> None:
    """coded_matvec against its plain version at ragged shapes, in all
    three type pairs and both routes: float64 outputs at 1e-12, float32
    outputs at 2e-3 (the reference's kernel tolerance), relative to 1 +
    max |want|; every call repeated bit for bit."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    from repro_torch.kernels.plan import MV_COLS, matvec_plan
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    routes, worst, n = set(), {}, 0
    for B, R, K, C in MATVEC_EDGES:
        for ti, to in ((torch.float32, torch.float32),
                       (torch.float32, torch.float64),
                       (torch.float64, torch.float64)):
            vec = 16 // torch.tensor([], dtype=ti).element_size()
            Kp = -(-K // vec) * vec
            a = torch.zeros((B, R, Kp), device=dev, dtype=ti)
            x = torch.zeros((B, Kp, C), device=dev, dtype=ti)
            a[..., :K] = torch.randn((B, R, K), generator=gen, device=dev,
                                     dtype=ti)
            x[:, :K] = torch.randn((B, K, C), generator=gen, device=dev,
                                   dtype=ti)
            if B == 1:
                a, x = a[0], x[0]
            got = coded_matvec_cuda(a, x, out_dtype=to)
            want = ref.coded_matvec_ref(a, x, out_dtype=to)
            rel = 1e-12 if to == torch.float64 else 2e-3
            err = max_err(got, want)
            tol = rel * (1 + float(want.abs().max()))
            tag = (f"coded_matvec B {B} R {R} K {K} C {C} "
                   f"{str(ti).split('.')[-1]} -> {str(to).split('.')[-1]}")
            if err > tol or got.shape != want.shape:
                raise AssertionError(f"{tag}: disagrees ({err} > {tol})")
            repeat_equal(tag, got,
                         lambda: coded_matvec_cuda(a, x, out_dtype=to), 2)
            kind = f"{str(ti).split('.')[-1]} -> {str(to).split('.')[-1]}"
            worst[kind] = max(worst.get(kind, 0.0), err / tol)
            routes |= {matvec_plan(a.element_size(), R, Kp,
                                   min(MV_COLS, C - c0), B, sms).route
                       for c0 in range(0, C, MV_COLS)}
            n += 1
    torch.cuda.synchronize()
    if routes != {"staged", "direct"}:
        raise AssertionError(f"coded_matvec edge sweep took only {routes}")
    print(f"[c] coded_matvec edge sweep: {n} shapes x types on both routes "
          f"agree with the plain version (largest err / tol "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }) and repeat "
          f"bit for bit, in {time.perf_counter() - t0:.1f} s", flush=True)


def print_plan(label: str, dtype: str, M: int, N: int, K: int,
               batch: int = 1) -> None:
    """The launch plan a GEMM kernel runs at one of phase c's shapes."""
    import torch
    from repro_torch.kernels.plan import gemm_plan
    p = gemm_plan(dtype, M, N, K, batch, torch.cuda.get_device_properties(
        0).multi_processor_count)
    c = p.config
    print(f"[c] plan {label}: {c.name} {c.bm} x {c.bn} tiles ({p.n_tile} "
          f"columns computed), {c.threads} threads, grid {p.grid} = "
          f"{p.blocks} blocks, {p.splits} K slabs of {p.k_span}", flush=True)


#: phase c's edge shapes: (B, L, L~, S, shared G, systematic, unaligned)
#: -- ragged everything, K odd, S in {1, 7, 50, 64, 65}, L~ = L, split K,
#: and operands whose data_ptr is not 16-byte aligned
ENCODE_EDGES = ((1, 300, 700, 1, True, True, False),
                (4, 257, 600, 7, False, True, False),
                (1, 2048, 2300, 50, True, True, False),
                (1, 4095, 4600, 64, True, True, True),
                (4, 500, 900, 65, False, True, True),
                (4, 333, 333, 50, True, True, False),
                (2, 128, 300, 64, False, False, False),
                (3, 1000, 1500, 130, True, True, False))
#: (M, K, N, unaligned) for matmul
MATMUL_EDGES = ((1, 1, 1, False), (37, 1001, 129, False),
                (130, 257, 4, True), (64, 8192, 96, False),
                (256, 4096, 2048, True), (300, 2000, 260, False))


def gemm_edge_sweep(dev) -> None:
    """The two GEMM kernels against their plain versions at ragged and
    unaligned shapes, each at its tolerance, the systematic prefix
    bit-equal."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.mds_encode import mds_encode_dev
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(shape, dt, unaligned=False):
        """A contiguous tensor; ``unaligned`` puts it one element into its
        storage (not 16-byte aligned)."""
        n = 1
        for d in shape:
            n *= d
        off = 1 if unaligned else 0
        flat = torch.randn((n + off,), generator=gen, device=dev, dtype=dt)
        return flat[off:].view(shape)

    t0 = time.perf_counter()
    worst = {}
    for dt, rel in ((torch.float64, 1e-12), (torch.float32, 2e-3)):
        for B, L, Lt, S, shared, sysm, unal in ENCODE_EDGES:
            g = rand((Lt, L) if shared else (B, Lt, L), dt, unal)
            a = rand((B, L, S), dt, unal)
            got = mds_encode_dev(g, a, systematic=sysm)
            sys_on = sysm and Lt > L
            want = torch.cat([a, ref.mds_encode_ref(g[..., L:, :], a)],
                             dim=1) if sys_on else ref.mds_encode_ref(g, a)
            err = max_err(got, want)
            tol = rel * (1 + float(want.abs().max()))
            kind = f"mds_encode {str(dt).split('.')[-1]}"
            tag = (f"{kind} B {B} L {L} L~ {Lt} S {S} "
                   f"{'shared' if shared else 'per-task'} G"
                   f"{'' if sysm else ', systematic=False'}"
                   f"{', unaligned' if unal else ''}")
            if err > tol or got.shape != want.shape:
                raise AssertionError(f"{tag}: disagrees ({err} > {tol})")
            if sys_on and not torch.equal(got[:, :L], a):
                raise AssertionError(f"{tag}: prefix is not A bit for bit")
            worst[kind] = max(worst.get(kind, 0.0), err / tol)
    for M, K, N, unal in MATMUL_EDGES:
        a = rand((M, K), torch.float32, unal)
        b = rand((K, N), torch.float32, unal)
        got = matmul_cuda(a, b)
        want = ref.matmul_ref(a, b)
        err = max_err(got, want)
        tol = 2e-3 * (1 + float(want.abs().max()))
        if err > tol or got.shape != (M, N):
            raise AssertionError(f"matmul M {M} K {K} N {N}"
                                 f"{' unaligned' if unal else ''}: "
                                 f"disagrees ({err} > {tol})")
        worst["matmul"] = max(worst.get("matmul", 0.0), err / tol)
    torch.cuda.synchronize()
    print(f"[c] GEMM edge sweep: {2 * len(ENCODE_EDGES)} mds_encode and "
          f"{len(MATMUL_EDGES)} matmul shapes agree with their plain "
          f"versions (largest err / tol "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _wkv6_inputs(dev, B: int, T: int, dtype, lo=None, hi=None,
                 state: bool = False, seed: int = 0, zero_every: int = 0,
                 H: int = None, K: int = None, V: int = None) -> tuple:
    """WKV inputs, by default at rwkv6-7b's head shape, as the mixer makes
    them: r, k, v ~ N(0, 1); decays exp(-exp(-2 + 0.05 N)) (the random
    init's w0 and LoRA scale) or uniform in [lo, hi], every
    ``zero_every``-th step exactly 0 when it is set; u ~ N(0, 0.1^2) per
    head."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = WKV_H if H is None else H
    K = WKV_K if K is None else K
    V = K if V is None else V
    BH = B * H

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k = (n(BH, T, K).to(dtype) for _ in range(2))
    v = n(BH, T, V).to(dtype)
    if lo is None:
        w = torch.exp(-torch.exp(-2.0 + 0.05 * n(BH, T, K)))
    else:
        w = lo + (hi - lo) * torch.rand((BH, T, K), generator=gen,
                                        device=dev)
    if zero_every:
        w[:, ::zero_every] = 0.0
    u = 0.1 * n(H, K)
    s0 = n(BH, K, V) if state else None
    return r, k, v, w.to(dtype), u, s0


def _wkv6_bound(B: int, T: int, esz: int, state: bool) -> tuple:
    """Least time of one WKV call: each input read once (r, k, v, w, u,
    and S_0 when given), each output written once (o, S_T); and the
    operations of the route wkv6_plan gives T.  The decode step (T <= 1)
    runs about 6 K V float32 operations per (b, h) outside the tensor
    cores.  The chunked route (T > 1) runs its two K x V products a step,
    the carry-in (r ⊙ F) S and the state update (k ⊙ G)ᵀ v, 2 K V
    operations each, on the TF32 tensor cores, once for each product its
    precision route takes: the state update two for bf16 inputs (v exact,
    the float32 factor split) and three for float32, the output products
    one for bf16 and three for float32.  The chunk's strict-causal
    products and the FMA-pipe work are left out, so this stays a lower
    bound."""
    BH, K = B * WKV_H, WKV_K
    nbytes = (esz * 4 * BH * T * K + 4 * WKV_H * K + esz * BH * T * K
              + 4 * BH * K * K * (2 if state else 1))
    if T <= 1:
        return bound(nbytes, [6.0 * BH * T * K * K / F32_FLOP_PER_S])
    products = 2 + 1 if esz == 2 else 3 + 3
    return bound(nbytes, [2.0 * products * BH * T * K * K / TF32_FLOP_PER_S])


#: phase c's wkv6 decay sweeps (lo, hi, every n-th step exactly 0):
#: moderate to strong; strong throughout (the plain chunked form's
#: exp(-cumsum(log w)) leaves float32's range); below the 1e-12 clamp
WKV_DECAYS = ((0.05, 0.999, 0), (0.05, 0.25, 0), (0.0, 1e-11, 5))
#: phase c's wkv6 edge shapes (B, H, T, K, V, with S_0): T of 0, 1, one
#: ragged chunk and several; K across both compiled head sizes (padded);
#: V ragged against the 32-column blocks and the 16-byte decode rows
WKV_EDGES = ((1, 3, 1, 8, 33, True), (2, 2, 0, 16, 8, True),
             (1, 2, 5, 24, 40, False), (2, 1, 17, 64, 64, True),
             (1, 2, 37, 72, 20, True), (1, 1, 100, 128, 70, False),
             (1, 2, 33, 16, 16, True), (3, 2, 1, 64, 6, False))


def wkv6_edge_sweep(dev) -> None:
    """The wkv6 kernels against the plain version at WKV_EDGES, both
    input types, at phase c's tolerances."""
    import torch
    from repro_torch.kernels import ref, wkv6 as wk
    worst = 0.0
    for (B, H, T, K, V, st) in WKV_EDGES:
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, s0 = _wkv6_inputs(dev, B, T, dt, state=st,
                                             seed=T + K + V, H=H, K=K, V=V)
            out, s_fin = wk.wkv6_cuda(r, k, v, w, u, s0)
            if T == 0:
                want = out.new_zeros(out.shape)
                s_want = s0 if st else torch.zeros_like(s_fin)
            else:
                want, s_want = ref.wkv6_chunked_ref(
                    *(t.reshape(B, H, *t.shape[1:]) for t in (r, k, v, w)),
                    u, None if s0 is None else s0.reshape(B, H, K, V))
            torch.cuda.synchronize()
            tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-5) * (
                1 + (float(want.float().abs().max()) if want.numel() else 0))
            s_tol = 1e-5 * (1 + float(s_want.abs().max()))
            err = max_err(out, want.reshape(out.shape)) if out.numel() \
                else 0.0
            s_err = max_err(s_fin, s_want.reshape(s_fin.shape))
            worst = max(worst, err / tol, s_err / s_tol)
            if err > tol or s_err > s_tol:
                raise AssertionError(
                    f"wkv6 edge B {B} H {H} T {T} K {K} V {V} S_0 {st} "
                    f"{dt}: out {err} (tol {tol}), state {s_err} (tol "
                    f"{s_tol})")
    print(f"[c] wkv6: {len(WKV_EDGES)} edge shapes x 2 types agree with "
          f"the plain version (largest err / tol {worst:.3g})", flush=True)
    # S_0 and S_T may alias (an in-place step): through the C entry point
    # with one state buffer, both routes, bit-equal to the separate buffers
    from repro_torch.kernels._launch import stream_ptr
    from repro_torch.kernels.plan import wkv6_plan
    for B, T in ((4, 1), (1, 37)):
        r, k, v, w, u, s0 = _wkv6_inputs(dev, B, T, torch.bfloat16,
                                         state=True, seed=5)
        want, s_want = wk.wkv6_cuda(r, k, v, w, u, s0)
        BH = B * WKV_H
        p = wkv6_plan(T, WKV_K, WKV_K, BH, 4)
        out, s = torch.empty_like(want), s0.clone()
        err = wk._lib().repro_wkv6(
            1, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s.data_ptr(), out.data_ptr(), s.data_ptr(), BH,
            WKV_H, T, WKV_K, WKV_K, p.route_code, p.chunk, p.sub, p.kk,
            p.vb, p.vec, p.grid[0], p.smem_bytes, p.blocks_per_sm,
            stream_ptr(dev))
        torch.cuda.synchronize()
        if err or not (torch.equal(out, want) and torch.equal(s, s_want)):
            raise AssertionError(f"wkv6 in place ({p.route}, T {T}) differs "
                                 f"from separate state buffers (err {err})")
    print("[c] wkv6: in-place state (S_0 = S_T) bit-equal on both routes",
          flush=True)


def wkv6_rows(dev, report) -> dict:
    """The wkv6 kernels against their plain version (the chunked form the
    model's reference runs) at rwkv6-7b's path shapes, in bf16 (the path)
    and float32, against the sequential oracle at strong decays in both,
    and at edge shapes.  Each shape is timed as a single call, as calls
    queued back to back, and as calls replayed from a CUDA graph (device
    time alone), beside a one-element kernel timed the same two ways (the
    launch floor).  Returns the serving prefill's, the decode's and the
    float32 long prefill's numbers for the JSON line.

    Tolerances: float32 outputs at 1e-5 x (1 + max |plain|) -- one
    recurrence in float32, summed in another order; bf16 outputs at 2^-7
    x (1 + max |plain|) -- both round a float32 result to bf16, at most
    one bf16 step apart at the largest output (the kernel's output
    products round their operands to TF32, ~2^-10 a term); the final
    state at 1e-5 x (1 + max |S|) for both types."""
    import torch
    from repro_torch.kernels import ref, wkv6 as wk
    from repro_torch.kernels.plan import wkv6_plan

    def views(B, r, k, v, w, s0):
        """(BH, T, .) rows as the plain version's (B, H, T, .)."""
        return [None if t is None else t.reshape(B, WKV_H, *t.shape[1:])
                for t in (r, k, v, w, s0)]

    def plain(B, r, k, v, w, u, s0):
        rb, kb, vb, wb, sb = views(B, r, k, v, w, s0)
        return ref.wkv6_chunked_ref(rb, kb, vb, wb, u, sb)

    one = torch.zeros(1, device=dev)
    floor_q = time_queued_ms(lambda: one.add_(1.0))
    floor_g = time_graph_ms(lambda: one.add_(1.0))
    print(f"[c] launch floor: a one-element kernel {floor_q * 1e3:.2f} us "
          f"queued, {floor_g * 1e3:.2f} us from a graph", flush=True)
    extra = {"launch_floor": {"queued_ms": floor_q, "graph_ms": floor_g}}
    for label, (B, T) in WKV_SHAPES.items():
        state = T == 1
        p = wkv6_plan(T, WKV_K, WKV_K, B * WKV_H, 4)
        print(f"[c] plan wkv6 {label} B {B} T {T}: {p.route}, chunk "
              f"{p.chunk}, sub-chunk {p.sub}, head padded to {p.kk}, "
              f"{p.vb} columns a block ({p.vec} a decode thread), grid "
              f"{p.grid} = {p.blocks} blocks of {p.threads} threads, "
              f"{p.smem_bytes} B shared, {p.blocks_per_sm} an SM",
              flush=True)
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, s0 = _wkv6_inputs(dev, B, T, dt, state=state)
            out, s_fin = wk.wkv6_cuda(r, k, v, w, u, s0)
            want, s_want = plain(B, r, k, v, w, u, s0)
            torch.cuda.synchronize()
            scale = 1 + float(want.float().abs().max())
            tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-5) * scale
            err = max_err(out, want.reshape(out.shape))
            s_err = max_err(s_fin, s_want.reshape(s_fin.shape))
            s_tol = 1e-5 * (1 + float(s_want.abs().max()))

            def call():
                return wk.wkv6_cuda(r, k, v, w, u, s0)
            ms = time_ms(call, 20)
            q_ms = time_queued_ms(call)
            g_ms = time_graph_ms(call)
            plain_ms = time_ms(lambda: plain(B, r, k, v, w, u, s0))
            bnd = _wkv6_bound(B, T, r.element_size(), state)
            name = str(dt).split(".")[-1]
            tag = (f"wkv6 {label} B {B} H {WKV_H} T {T} K = V {WKV_K} "
                   f"{name}{' with S_0' if state else ''}")
            if s_err > s_tol:
                raise AssertionError(f"{tag}: final state disagrees with "
                                     f"the plain version ({s_err} > "
                                     f"{s_tol})")
            if label == "long prefill" and dt == torch.bfloat16:
                repeat_equal("wkv6 long prefill out", out, lambda: call()[0])
                repeat_equal("wkv6 long prefill state", s_fin,
                             lambda: call()[1])
            print(f"[c] {tag}: max_abs_err={err:.3e} (tol {tol:.3e}), "
                  f"state {s_err:.3e} (tol {s_tol:.3e}); kernel {ms:.4f} ms "
                  f"single, {q_ms:.4f} queued, {g_ms:.4f} from a graph "
                  f"(host share of a single call {ms - g_ms:.4f}); plain "
                  f"{plain_ms:.3f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), "
                  f"graph / bound {g_ms / bnd[0]:.2f}", flush=True)
            if err > tol:
                raise AssertionError(f"{tag}: kernel disagrees with its "
                                     f"plain version ({err} > {tol})")
            nums = dict(max_abs_err=err, state_err=s_err, ms=ms,
                        queued_ms=q_ms, graph_ms=g_ms, plain_ms=plain_ms,
                        bound_ms=bnd[0], bound_by=bnd[1], route=p.route)
            if label == "long prefill" and dt == torch.bfloat16:
                report("wkv6", "src/repro_torch/csrc/wkv6.cu",
                       "src/repro/kernels/wkv6.py:71", err, tol, ms,
                       plain_ms, None, bnd, queued_ms=q_ms, graph_ms=g_ms)
            else:
                extra[f"{label} {name}".replace(" ", "_")] = nums
            del r, k, v, w, out, want

    # strong decays against the sequential oracle, in both types
    B, T = WKV_SHAPES["long prefill"]
    for lo, hi, zero in WKV_DECAYS:
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, _ = _wkv6_inputs(dev, B, T, dt, lo, hi, seed=1,
                                            zero_every=zero)
            out, _ = wk.wkv6_cuda(r, k, v, w, u)
            oracle_ms, want = time_once(lambda: ref.wkv6_chunk_ref(
                *views(B, r, k, v, w, None)[:4], u))
            chunked, _ = plain(B, r, k, v, w, u, None)
            err = max_err(out, want.reshape(out.shape))
            tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-5) * (
                1 + float(want.float().abs().max()))
            finite = bool(torch.isfinite(chunked).all())
            c_err = max_err(chunked, want) if finite else float("nan")
            name = str(dt).split(".")[-1]
            print(f"[c] wkv6 decays w in [{lo}, {hi}]"
                  f"{f', every {zero}th step 0' if zero else ''} T {T} "
                  f"{name}: max_abs_err={err:.3e} against the sequential "
                  f"oracle (tol {tol:.3e}, oracle {oracle_ms:.1f} ms); "
                  f"chunked plain form finite {finite}, its error "
                  f"{c_err:.3e}", flush=True)
            if err > tol or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"wkv6 at decays [{lo}, {hi}] {name} "
                                     f"disagrees with the oracle ({err})")
            del r, k, v, w, out, want, chunked
    wkv6_edge_sweep(dev)
    torch.cuda.empty_cache()
    return extra


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


def _coded_head(dev, seed: int, product_dtype, arch: str = ARCH,
                phase: str = "e", twin: bool = False) -> object:
    """One full-width coded-head serve; returns its ServeReport.  With
    ``twin`` the same bridge then serves the requests uncoded, and the
    tokens must be equal."""
    import torch
    from repro_torch import kernels
    from repro_torch.obs import Tracer
    from repro_torch.serve_coded import CodedServingBridge, synthetic_requests
    from repro_torch.stream import AdmissionConfig
    before = kernels.launch_counts()
    # traced: device spans synchronise, so the per-stage wall is honest
    tracer = Tracer(meta={"entry": "chip_smoke", "phase": phase})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    bridge = CodedServingBridge(
        masters=1, arch=arch, smoke=False, seed=seed,
        slots_per_master=CODED_SLOTS, backend="torch",
        parity_storage="virtual", device_products=True, verify=True,
        admission=AdmissionConfig(policy="edf"), tracer=tracer, device=dev,
        product_dtype=product_dtype)
    bridge._setup_model(CODED_PROMPT + CODED_GEN + 8)
    tag = f"seed {seed}, {str(product_dtype).split('.')[-1]} products"
    print(f"[{phase}] {tag}: coded head L={bridge.head.L} D={bridge.head.D}; "
          f"setup {time.perf_counter() - t0:.1f} s", flush=True)
    def reqs():
        return synthetic_requests(CODED_REQUESTS, masters=1,
                                  vocab=bridge._model["cfg"].vocab,
                                  prompt_len=CODED_PROMPT,
                                  gen_len=CODED_GEN, rate=0.004, seed=seed)
    rep = bridge.serve(reqs())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    sizes = _frozen_solve_sizes(bridge)
    after = kernels.launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    print(f"[{phase}] {tag}: frozen-plan decode-solve sizes s={sizes}, solve "
          f"steps {rep.solve_steps}/{len(rep.steps)}, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[{phase}] {tag}: wall {rep.wall_seconds:.2f} s, "
          f"{rep.tokens_generated} tokens "
          f"({rep.tokens_generated / rep.wall_seconds:.2f} tok/s), "
          f"max_err {rep.max_err:.3e}, argmax match "
          f"{rep.argmax_match_rate:.4f}, decode_ok(head tol) "
          f"{rep.decode_ok}; launches {grew}", flush=True)
    stages = {k: round(v, 3) for k, v in rep.per_stage_wall.items()}
    steps = [round(sp.dur, 3) for sp in tracer.spans
             if sp.cat == "step" and sp.name.startswith("step:")]
    print(f"[{phase}] {tag}: per-stage wall s {stages}; step walls s {steps} "
          f"(the first builds and factors the decode minor)", flush=True)
    split = {}
    for sp in tracer.spans:
        if sp.cat == "decode_split":
            split.setdefault(sp.name.split(":")[-1], []).append(sp.dur)
    print(f"[{phase}] {tag}: decode split (calls, s in all, first s; the "
          f"minor build is part of the factor): "
          + ", ".join(f"{k} {len(v)} {sum(v):.3f} {v[0]:.3f}"
                      for k, v in sorted(split.items()))
          + f"; decode {rep.per_stage_wall.get('decode', 0.0):.3f}",
          flush=True)
    answered = {rid: len(t) for rid, t in rep.tokens.items()}
    if len(answered) != CODED_REQUESTS or \
            any(n != CODED_GEN for n in answered.values()):
        raise AssertionError(f"not every request was answered: {answered}")
    if not sizes or not all(s > 0 for s in sizes):
        raise AssertionError(f"seed {seed} gave no parity solve")
    for k in ("coded_matvec", "gen_parity_matvec", "counter_parity_rows",
              "parity_contract") + (("wkv6",) if arch == RWKV else ()):
        if grew[k] <= 0:
            raise AssertionError(f"phase {phase} never launched {k}")
    if twin:
        bridge.coded, bridge.tracer = False, None
        t0 = time.perf_counter()
        plain = bridge.serve(reqs())
        print(f"[{phase}] {tag}: uncoded twin wall "
              f"{time.perf_counter() - t0:.2f} s, tokens equal "
              f"{plain.tokens == rep.tokens}", flush=True)
        if plain.tokens != rep.tokens:
            raise AssertionError(f"phase {phase}: coded tokens differ from "
                                 f"the uncoded twin's")
    # the bridge's serve closures form reference cycles: collect them so
    # its decode minor is freed before the next seed's is built
    del bridge
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def phase_e(dev) -> None:
    """Coded serving of llama3.2-1b at its published widths, gated."""
    import torch
    from repro_torch.launch import serve
    # first the reference's float32 products on seed 1: the error that the
    # float64 products remove (a measurement, not a gate)
    _coded_head(dev, CODED_SEEDS[0], torch.float32)
    for seed in CODED_SEEDS:
        rep = _coded_head(dev, seed, torch.float64)
        if not rep.decode_ok:
            raise AssertionError(
                f"seed {seed}: the full-width coded head misses the 5e-4 "
                f"head tolerance (max_err {rep.max_err:.3e}, argmax match "
                f"{rep.argmax_match_rate})")
    serve._MODEL_CACHE.clear()
    torch.cuda.empty_cache()


def fresh_card(dev, phase: str) -> None:
    """Release every model and bridge, so a phase starts from a clean
    card, and print what is still allocated."""
    import torch
    from repro_torch.launch import serve
    serve._MODEL_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{phase}] start: {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB allocated", flush=True)


def phase_j(dev) -> None:
    """Uncoded serving of rwkv6-7b at its published widths, gated on
    prefill + decode against the full forward."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, model_fwd, prefill
    fresh_card(dev, "j")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = serve.build_model(RWKV, smoke=False, seed=0, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"[j] {cfg.name}: d_model {cfg.d_model}, {cfg.n_repeats} layers, "
          f"{cfg.d_model // cfg.rwkv_head_size} heads of "
          f"{cfg.rwkv_head_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, {n_par:.4e} parameters; init "
          f"{time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    rng = np.random.default_rng(0)
    for B, P, G in RWKV_RUNS:
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                size=(B, P))).to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        serve.generate(cfg, params, prompts, 2)              # warm-up
        toks, t_pre, t_dec = serve.generate(cfg, params, prompts, G)
        peak = torch.cuda.max_memory_allocated(dev)
        if toks.shape != (B, G) or (toks < 0).any() or \
                (toks >= cfg.vocab).any():
            raise AssertionError(f"phase j: bad tokens {toks}")
        # the gate: prefill of the first P - 1 tokens + one kernel decode
        # step against the full forward over all P, at the last position
        with torch.inference_mode():
            full = model_fwd(params, {"tokens": prompts},
                             cfg=cfg)["logits"][:, -1].float()
            caches = serve.zero_caches(cfg, B, P + 8, device=dev)
            _, caches = prefill(params, {"tokens": prompts[:, :-1]}, caches,
                                cfg=cfg)
            pos = torch.full((B,), P - 1, dtype=torch.int64, device=dev)
            inc, _ = decode_step(params, prompts[:, -1:], pos, caches,
                                 cfg=cfg)
            inc = inc[:, 0].float()
        err = max_err(inc, full)
        tol = RWKV_LOGIT_TOL * (1 + float(full.abs().max()))
        agree = float((inc.argmax(-1) == full.argmax(-1)).float().mean())
        finite = bool(torch.isfinite(inc).all() and torch.isfinite(full).all())
        print(f"[j] uncoded serve {B} x prompt {P} x gen {G}: prefill "
              f"{B * P / t_pre:.1f} tok/s ({t_pre * 1e3:.1f} ms), decode "
              f"{B * (G - 1) / t_dec:.1f} tok/s ({t_dec * 1e3:.1f} ms), "
              f"peak {peak / 2**30:.2f} GiB", flush=True)
        print(f"[j] prefill + decode vs full forward at position {P - 1}: "
              f"max |dlogit| {err:.4e} (tol {tol:.4e}, max |logit| "
              f"{float(full.abs().max()):.4f}), argmax agreement {agree}",
              flush=True)
        if not finite or err > tol:
            raise AssertionError(f"phase j: prefill + decode misses the "
                                 f"full forward ({err} > {tol})")
        del caches, full, inc
    del params
    serve._MODEL_CACHE.clear()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_k(dev) -> None:
    """Coded head serving of rwkv6-7b at its published widths, gated."""
    import torch
    fresh_card(dev, "k")
    for seed in RWKV_CODED_SEEDS:
        rep = _coded_head(dev, seed, torch.float64, arch=RWKV, phase="k")
        fresh_card(dev, "k")
        if not rep.decode_ok or rep.argmax_match_rate != 1.0:
            raise AssertionError(
                f"seed {seed}: the rwkv6-7b coded head misses the 5e-4 "
                f"head tolerance or the uncoded argmax (max_err "
                f"{rep.max_err:.3e}, argmax match {rep.argmax_match_rate})")


#: phase l's serve: 4 requests x prompt 32 x gen 8 on 4 slots of one
#: master, coding_scope="trunk" (16 x 7 + 1 = 113 coded matmuls a step)
TRUNK_REQUESTS, TRUNK_PROMPT, TRUNK_GEN, TRUNK_SLOTS = 4, 32, 8, 4
#: phase l's seed candidates, probed in order (``plan_probe``)
TRUNK_SEED_CANDIDATES = range(10)
#: phase l's faulted serve: the published widths at 2 of the 16 layers
TRUNK_FAULT_LAYERS = 2


class _ProbeTrunk:
    """``HostTrunk``'s interface without weights, for
    :func:`plan_probe`: each layer's stages go through the bridge's
    grouped hook on zero activations one column wide; a weight is a
    broadcast (L, 1) zero array, so only the heights exist."""

    def __init__(self, cfg, params, head_W):
        from repro_torch.serve_coded import trunk_matmul_keys
        rows = {"wq": cfg.n_heads * cfg.d_head,
                "wk": cfg.n_kv_heads * cfg.d_head,
                "wv": cfg.n_kv_heads * cfg.d_head, "wo": cfg.d_model,
                "w_in": cfg.d_ff, "w_gate": cfg.d_ff, "w_out": cfg.d_model}
        self.keys = trunk_matmul_keys(cfg, "trunk")
        self.weights = {k: np.broadcast_to(0.0, (rows[k.split(".")[1]], 1))
                        for k in self.keys}
        self.n_layers = len(self.keys) // 7

    def zero_caches(self, batch, max_len):
        return {}

    def forward(self, tokens, positions, rows, caches, mm=None,
                collect=None, mm_group=None):
        R, T = np.shape(tokens)
        X = np.zeros((R * T, 1))
        for i in range(self.n_layers):
            for stage in (("wq", "wk", "wv"), ("wo",), ("w_in", "w_gate"),
                          ("w_out",)):
                mm_group([(f"blk{i}.{k}", X) for k in stage])
        return np.zeros((R, T, 1))


def _probe_serving_fns(cfg, return_hidden=False):
    """``serving_fns`` for :func:`plan_probe`'s head scope: no model, zero
    hidden states one column wide, no caches."""
    import torch

    def prefill_fn(p, batch, caches):
        return None, caches, torch.zeros((batch["tokens"].shape[0], 1, 1))

    def decode_fn(p, toks, pos, caches):
        return None, caches, torch.zeros((toks.shape[0], 1, 1))

    return prefill_fn, decode_fn


def plan_probe(cfg, seed: int, scope: str = "trunk") -> dict:
    """The frozen prefix plans of a coded serve at ``seed`` -- phase l's
    trunk-scope serve, or with ``scope="head"`` phase e's head-scope
    serve (CODED_*) -- from the bridge's timing alone: the serve runs
    without weights (a weightless trunk, :class:`_ProbeTrunk`, or zero
    hidden states) and with stage executions that return zeros, so no
    product and no decode is computed.  A plan depends on the heights,
    the pool, the arrivals and the delays, not on the weights.  Returns
    ``{key: [parity rows of each frozen plan]}``."""
    from repro_torch.launch import serve
    from repro_torch.models import padded_vocab
    from repro_torch.serve_coded import CodedServingBridge, synthetic_requests
    from repro_torch.serve_coded import bridge as br
    from repro_torch.stream import AdmissionConfig
    n_req, prompt, gen, slots = (
        (TRUNK_REQUESTS, TRUNK_PROMPT, TRUNK_GEN, TRUNK_SLOTS)
        if scope == "trunk" else
        (CODED_REQUESTS, CODED_PROMPT, CODED_GEN, CODED_SLOTS))
    saved = (serve.build_model, serve.head_matrix, serve.serving_fns,
             serve.zero_caches, br.HostTrunk, br._BarrierExecutor.execute,
             br.CodedLinear.parity_ctrs)
    serve.build_model = lambda *a, **kw: (cfg, None)
    serve.head_matrix = lambda c, p: np.broadcast_to(
        0.0, (padded_vocab(cfg), 1))
    serve.serving_fns = _probe_serving_fns
    serve.zero_caches = lambda *a, **kw: {}
    br.HostTrunk = _ProbeTrunk
    br._BarrierExecutor.execute = lambda self, items, **kw: {
        k: np.zeros((X.shape[0], self.linears[k].L)) for k, X in items}
    # a row's counter walks its block's conditioning guard (a parity
    # derivation); which rows a prefix takes does not depend on it
    br.CodedLinear.parity_ctrs = lambda self, ids: np.zeros(len(ids),
                                                            np.uint32)
    try:
        bridge = CodedServingBridge(
            masters=1, arch=cfg.name, smoke=False, seed=seed,
            slots_per_master=slots, coding_scope=scope,
            backend="numpy", parity_storage="virtual", verify=False,
            admission=AdmissionConfig(policy="edf"), device="cpu")
        bridge._setup_model(prompt + gen + 8)
        bridge.serve(synthetic_requests(
            n_req, masters=1, vocab=cfg.vocab, prompt_len=prompt,
            gen_len=gen, rate=0.004, seed=seed))
    finally:
        (serve.build_model, serve.head_matrix, serve.serving_fns,
         serve.zero_caches, br.HostTrunk, br._BarrierExecutor.execute,
         br.CodedLinear.parity_ctrs) = saved
    return frozen_parity_rows(bridge)


def frozen_parity_rows(bridge) -> dict:
    """``{key: [parity rows of each frozen plan]}`` of a served bridge."""
    out = {}
    for e in bridge._plan_cache._entries.values():
        if not e.plans:
            continue
        for key, plan in e.plans.items():
            L = bridge._linears[key].L
            out.setdefault(key, []).append(int((plan.rows >= L).sum()))
    return out


def host_rss_gib() -> tuple:
    """(current, peak) resident host memory of this process, GiB."""
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    cur = 0.0
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                cur = int(ln.split()[1]) / 2**20
    return cur, peak


def _trunk_bridge(dev, seed: int, *, tracer=None, faults=None):
    from repro_torch.serve_coded import CodedServingBridge
    from repro_torch.stream import AdmissionConfig
    bridge = CodedServingBridge(
        masters=1, arch=ARCH, smoke=False, seed=seed,
        slots_per_master=TRUNK_SLOTS, coding_scope="trunk", backend="torch",
        parity_storage="virtual", device_products=True, verify=True,
        admission=AdmissionConfig(policy="edf"), tracer=tracer,
        faults=faults, device=dev)
    bridge._setup_model(TRUNK_PROMPT + TRUNK_GEN + 8)
    return bridge


def _trunk_requests(bridge, seed: int):
    from repro_torch.serve_coded import synthetic_requests
    return synthetic_requests(TRUNK_REQUESTS, masters=1,
                              vocab=bridge._model["cfg"].vocab,
                              prompt_len=TRUNK_PROMPT, gen_len=TRUNK_GEN,
                              rate=0.004, seed=seed)


def _answered(rep, tag: str) -> None:
    answered = {rid: len(t) for rid, t in rep.tokens.items()}
    if len(answered) != TRUNK_REQUESTS or \
            any(n != TRUNK_GEN for n in answered.values()):
        raise AssertionError(f"{tag}: not every request was answered: "
                             f"{answered}")


def _pick_trunk_seed(cfg, head_solve: bool = True) -> int:
    """The first candidate seed whose frozen prefixes need a parity solve
    in some trunk key and — with ``head_solve`` — in the head, or else
    none in the head (``plan_probe``)."""
    sizes = {}
    for seed in TRUNK_SEED_CANDIDATES:
        fr = plan_probe(cfg, seed)
        head = fr.pop("head")
        trunk = sum(any(x > 0 for x in v) for v in fr.values())
        sizes[seed] = (head, trunk)
        if (max(head) > 0) == head_solve and trunk > 0:
            print(f"[l] probe, {cfg.n_repeats} layers: seed -> (head parity "
                  f"rows of each frozen plan, trunk keys with a solve of "
                  f"{len(fr)}): {sizes}; chosen seed {seed}", flush=True)
            return seed
    raise AssertionError(f"no candidate seed fits: {sizes}")


def phase_l(dev) -> None:
    """Trunk-scope coded serving of llama3.2-1b at its published widths,
    gated on exactness against the uncoded twin; then a faulted serve at
    2 layers."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.faults import FaultConfig
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    from repro_torch.obs import Tracer
    from repro_torch.serve_coded import packing
    fresh_card(dev, "l")
    cfg = get_config(ARCH)
    seed = _pick_trunk_seed(cfg)
    before = kernels.launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tracer = Tracer(meta={"entry": "chip_smoke", "phase": "l"})
    bridge = _trunk_bridge(dev, seed, tracer=tracer)
    n_keys = len(bridge._coded_keys)
    print(f"[l] seed {seed}: {n_keys} coded matmuls a step (head L="
          f"{bridge.head.L}); setup {time.perf_counter() - t0:.1f} s, host "
          f"RSS (now, peak) GiB {tuple(round(v, 2) for v in host_rss_gib())}",
          flush=True)
    # decodes per key, by kind: every packed problem's decode is either a
    # parity solve or a systematic scatter
    decodes = {}
    execute = packing.PackedStage.execute

    def counted(self, X, **kw):
        for p in self.problems:
            decodes.setdefault(p.key, [0, 0])[0 if p.used_solve else 1] += 1
        return execute(self, X, **kw)
    packing.PackedStage.execute = counted
    try:
        rep = bridge.serve(_trunk_requests(bridge, seed))
    finally:
        packing.PackedStage.execute = execute
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    grew = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    frozen = frozen_parity_rows(bridge)
    solved = sorted(k for k, (n, _) in decodes.items() if n)
    print(f"[l] frozen-plan parity rows: head {frozen['head']}, trunk keys "
          f"with a solve {sum(1 for k in solved if k != 'head')} of "
          f"{n_keys - 1}, largest trunk solve "
          f"{max(max(v) for k, v in frozen.items() if k != 'head')}",
          flush=True)
    layers = {}
    for k, (a, b) in decodes.items():
        blk, _, name = k.rpartition(".")
        layers.setdefault(blk or k, []).append(f"{name} {a}/{b}")
    for blk, line in layers.items():
        print(f"[l] decodes (solve/systematic) {blk}: {', '.join(line)}",
              flush=True)
    stages = {k: round(v, 3) for k, v in rep.per_stage_wall.items()}
    print(f"[l] wall {rep.wall_seconds:.2f} s, {rep.tokens_generated} tokens "
          f"({rep.tokens_generated / rep.wall_seconds:.3f} tok/s), "
          f"{len(rep.steps)} steps, solve steps {rep.solve_steps}; "
          f"per-stage wall s {stages}", flush=True)
    print(f"[l] max_err {rep.max_err:.3e} (the bridge's gate outside the "
          f"head: 2e-2), argmax match {rep.argmax_match_rate:.4f}, "
          f"decode_ok {rep.decode_ok}; peak device memory "
          f"{peak / 2**30:.2f} GiB, host RSS (now, peak) GiB "
          f"{tuple(round(v, 2) for v in host_rss_gib())}; launches {grew}",
          flush=True)
    _answered(rep, "phase l")
    if not rep.decode_ok or rep.argmax_match_rate != 1.0:
        raise AssertionError(f"phase l: decode_ok {rep.decode_ok}, argmax "
                             f"match {rep.argmax_match_rate}")
    if "head" not in solved or len(solved) < 2:
        raise AssertionError(f"phase l: seed {seed} decoded no parity solve "
                             f"in the head and the trunk: {solved}")
    for k in ("coded_matvec", "parity_contract", "gen_parity_matvec"):
        if grew[k] <= 0:
            raise AssertionError(f"phase l never launched {k}")
    # the identically scheduled uncoded twin: the same bridge, coding off
    bridge.coded, bridge.tracer = False, None
    t0 = time.perf_counter()
    plain = bridge.serve(_trunk_requests(bridge, seed))
    print(f"[l] uncoded twin: wall {time.perf_counter() - t0:.2f} s, tokens "
          f"equal {plain.tokens == rep.tokens}", flush=True)
    if plain.tokens != rep.tokens:
        raise AssertionError("phase l: coded tokens differ from the uncoded "
                             "twin's")
    del bridge, rep, plain
    fresh_card(dev, "l")

    # -- faulted: the published widths at 2 layers, seeded into the memo.
    # Quarantines re-plan the serve, and a head plan can then need more
    # parity rows than the card holds as a float64 minor (~95k; seed 0's
    # faulted serve re-planned to ~110k): the seed is the first whose
    # frozen head prefix is systematic
    cut = dataclasses.replace(cfg, n_repeats=TRUNK_FAULT_LAYERS)
    seed = _pick_trunk_seed(cut, head_solve=False)
    serve._MODEL_CACHE[(ARCH, False, seed, str(dev))] = (
        cut, init_model(seed, cut, dev))
    fc = FaultConfig(seed=5, corrupt_rate=0.3, corrupt_kind="sign_flip",
                     retry_budget=4)
    print(f"[l] faulted serve: {TRUNK_FAULT_LAYERS} of {cfg.n_repeats} "
          f"layers, seed {seed}, {fc}", flush=True)
    bridge = _trunk_bridge(dev, seed)
    t0 = time.perf_counter()
    clean = bridge.serve(_trunk_requests(bridge, seed))
    t_clean = time.perf_counter() - t0
    bridge.faults = fc
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    rep = bridge.serve(_trunk_requests(bridge, seed))
    t_fault = time.perf_counter() - t0
    grew = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    f = rep.faults
    same = rep.tokens == clean.tokens
    degraded = (rep.decode_modes or {}).get("degraded", 0)
    print(f"[l] faulted: wall {t_fault:.2f} s (clean twin {t_clean:.2f} s), "
          f"tokens equal clean {same}, decode modes {rep.decode_modes}, "
          f"max_err {rep.max_err:.3e}, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          + ", ".join(f"{k} {f[k]}" for k in (
              "injected", "corrupt_steps", "corrupt_applied", "detected",
              "localized", "retries", "rows_rejected", "false_flags",
              "detection_rate", "localization_rate", "quarantines",
              "readmissions")) + f"; launches {grew}", flush=True)
    _answered(rep, "phase l faulted")
    if not (same or degraded > 0) or f["false_flags"] != 0 \
            or f["detection_rate"] < 0.99 or f["localization_rate"] < 0.99:
        raise AssertionError(f"phase l faulted serve: tokens equal {same}, "
                             f"degraded {degraded}, faults {f}")
    if f["corrupt_applied"] <= 0:
        raise AssertionError("phase l faulted serve: no corruption reached "
                             "a decode")
    del bridge
    fresh_card(dev, "l")


def _paper_plans(sc) -> dict:
    """Fig. 4's plans on the large scenario, as
    ``benchmarks/fig4_delay.py`` builds them."""
    from repro_torch.core import (fractional_greedy, iterated_greedy,
                                  plan_from_assignment, uncoded_uniform)
    k_it = iterated_greedy(sc, rng=0)
    return {"uncoded": uncoded_uniform(sc),
            "dedi-iter": plan_from_assignment(sc, k_it, method="dedi-iter"),
            "frac": fractional_greedy(sc, init=k_it)}


def ks_distance(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov distance of two samples."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, side="right") / a.size
                        - np.searchsorted(b, grid, side="right") / b.size
                        ).max())


def phase_m(dev) -> None:
    """The paper's Monte Carlo (Fig. 4's plans, the large scenario) on
    the card against the numpy stream."""
    import torch
    from repro_torch.core import large_scale_scenario
    from repro_torch.sim import simulate_plan
    sc = large_scale_scenario(0)
    plans = _paper_plans(sc)
    runs = [(name, plan, 0.0) for name, plan in plans.items()] \
        + [("frac", plans["frac"], 0.1)]
    sem = lambda x: float(np.std(x) / np.sqrt(x.size))  # noqa: E731
    for name, plan, sp in runs:
        kw = dict(keep_samples=True, straggle_p=sp)
        t0 = time.perf_counter()
        ref = simulate_plan(sc, plan, trials=MC_NUMPY_TRIALS, rng=1, **kw)
        t_np = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate_plan(sc, plan, trials=MC_TORCH_TRIALS, rng=2,
                            backend="torch", device=dev, **kw)
        t_dev = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        again = simulate_plan(sc, plan, trials=MC_TORCH_TRIALS, rng=2,
                              backend="torch", device=dev, **kw)
        se = float(np.hypot(sem(res.overall_samples),
                            sem(ref.overall_samples)))
        gap = abs(res.overall_mean - ref.overall_mean)
        ks = ks_distance(res.overall_samples, ref.overall_samples)
        same = np.array_equal(again.per_master_samples,
                              res.per_master_samples)
        print(f"[m] {name} (straggle_p {sp}, active nodes a master "
              f"{(plan.l > 0).sum(axis=1).tolist()}): mean torch "
              f"{res.overall_mean:.3f} ms / numpy {ref.overall_mean:.3f} "
              f"(gap {gap / se:.2f} combined SE), KS {ks:.4f}; "
              f"{MC_TORCH_TRIALS / t_dev:.4g} trials/s on the card "
              f"({t_dev:.3f} s), numpy {MC_NUMPY_TRIALS / t_np:.4g} "
              f"trials/s ({t_np:.3f} s); peak device memory "
              f"{peak / 2**20:.1f} MiB; same seed bit-equal {same}",
              flush=True)
        if gap > 4 * se or ks >= 0.01 or not same:
            raise AssertionError(f"phase m {name}: gap {gap / se:.2f} SE, "
                                 f"KS {ks:.4f}, repeatable {same}")


def _cut(cfg, cut):
    """``cfg`` at a depth cut: ``prefix`` / ``block`` keep their first
    layers, ``n_repeats`` is set; widths are kept."""
    import dataclasses
    if cut is None:
        return cfg
    kw = {}
    for k, v in cut.items():
        kw[k] = getattr(cfg, k)[:v] if k in ("prefix", "block") else v
    return dataclasses.replace(cfg, **kw)


def _uncapped(cfg):
    """The MoE capacity that drops no token: prefill + decode equals the
    full forward only without capacity competition."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))


def _features(cfg, B: int, dev) -> dict:
    """The frontend's stub features (0.1, float32), as the reference's
    launcher and smoke tests feed them."""
    import torch
    shape = (B, cfg.frontend_len, cfg.frontend_dim)
    if cfg.enc_dec:
        return {"enc_feats": torch.full(shape, 0.1, device=dev)}
    if cfg.frontend == "vision":
        return {"patch_feats": torch.full(shape, 0.1, device=dev)}
    return {}


def _decode_gate(tag: str, cfg, params, dev) -> None:
    """Prefill of P tokens + S decode steps against the full forward over
    the same P + S tokens (positions P - 1 .. P + S - 1), at an uncapped
    MoE capacity, at phase j's gate.  The encoder-decoder's decode steps
    get the encoder output; a vision model's serving is text-only, so its
    oracle is a prefill over all P + S tokens (the last position)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, model_fwd, prefill
    from repro_torch.models.lm import _encoder
    cfg = _uncapped(cfg)
    B, P, S = MIXER_GATE.get(cfg.name, MIXER_GATE_DEFAULT)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, P + S))).to(dev)
    feats = {k: v for k, v in _features(cfg, B, dev).items()
             if k == "enc_feats"}
    vision = cfg.frontend == "vision"
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if vision:
            full, _ = prefill(params, {"tokens": toks},
                              serve.zero_caches(cfg, B, P + S, device=dev),
                              cfg=cfg)
        else:
            full = model_fwd(params, {"tokens": toks, **feats},
                             cfg=cfg)["logits"][:, P - 1:]
        full = full.float()
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        enc = _encoder(params, feats["enc_feats"], cfg=cfg) \
            if cfg.enc_dec else None
        caches = serve.zero_caches(cfg, B, P + S + 8, device=dev)
        lg, caches = prefill(params, {"tokens": toks[:, :P], **feats},
                             caches, cfg=cfg)
        inc = [lg]
        for i in range(S):
            pos = torch.full((B,), P + i, dtype=torch.int64, device=dev)
            lg, caches = decode_step(params, toks[:, P + i:P + i + 1], pos,
                                     caches, cfg=cfg, enc_out=enc)
            inc.append(lg)
        inc = torch.cat(inc[-1:] if vision else inc, dim=1).float()
    err = max_err(inc, full)
    top = float(full.abs().max())
    tol = RWKV_LOGIT_TOL * (1 + top)
    agree = float((inc.argmax(-1) == full.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(inc).all() and torch.isfinite(full).all())
    # by position (over the batch): a router's top-k flipped by a bf16
    # rounding moves one token's logits, other positions stay small
    by_pos = (inc - full).abs().amax(dim=(0, 2)).tolist()
    print(f"[n] {tag}: prefill {P} + {S} decode steps (batch {B}) vs the "
          f"{'prefill' if vision else 'full forward'} over {P + S} tokens "
          f"({t_full:.2f} s): max |dlogit| {err:.4e} (tol {tol:.4e}, max "
          f"|logit| {top:.4f}), by position "
          f"{[round(e, 4) for e in by_pos]}, argmax agreement {agree}",
          flush=True)
    if not finite or err > tol:
        raise AssertionError(f"phase n {tag}: prefill + decode misses the "
                             f"full forward ({err} > {tol})")
    del full, inc, caches, enc


def _frontend_forward(tag: str, cfg, params, dev) -> None:
    """``model_fwd`` with the stub features: DeepSeek's MTP head, a vision
    model's patches (batch 1), the encoder-decoder's frames; finite
    outputs of the expected shapes."""
    import torch
    from repro_torch.models import model_fwd, padded_vocab
    B, T = (1, 32) if cfg.frontend == "vision" else (4, 32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, T))).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model_fwd(params, {"tokens": toks,
                                 **_features(cfg, B, dev)}, cfg=cfg)
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    print(f"[n] {tag}: model_fwd with "
          f"{sorted(_features(cfg, B, dev)) or 'tokens only'} "
          f"({time.perf_counter() - t0:.2f} s): {shapes} "
          f"({', '.join(f'{k} {v.dtype}' for k, v in out.items())}), "
          f"finite {finite}", flush=True)
    want = (B, T, padded_vocab(cfg))
    if not finite or any(v != want for v in shapes.values()) or \
            ("mtp_logits" in out) != cfg.mtp:
        raise AssertionError(f"phase n {tag}: model_fwd gave {shapes}, "
                             f"finite {finite}")
    del out


def _mamba_times(tag: str, cfg, params, dev) -> None:
    """The Mamba mixer alone (its first layer) at the serving shapes:
    the prefill's per-step float32 recurrence over 32 tokens, and one
    decode step, beside the bytes bound of reading the layer's weights
    and its state once."""
    import torch
    from repro_torch.models import ssm
    i = next(j for j, sp in enumerate(cfg.block) if sp.mixer == "mamba")
    p = {k: v[0] for k, v in params["blocks"][f"layer{i}"]["mixer"].items()}
    B, P, _ = MIXER_SERVE
    spec = ssm.mamba_cache_spec(cfg, B, p["w_in"].dtype)
    cache = {k: torch.zeros(sh, dtype=dt, device=dev)
             for k, (sh, dt) in spec.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    with torch.inference_mode():
        for T in (P, 1):
            x = torch.randn((B, T, cfg.d_model), generator=gen,
                            device=dev).to(p["w_in"].dtype)
            out[T] = time_ms(lambda: ssm.apply_mamba(p, x, cfg=cfg,
                                                     cache=cache))
    weights = sum(t.numel() * t.element_size() for t in p.values())
    state = sum(t.numel() * t.element_size() for t in cache.values())
    print(f"[n] {tag}: Mamba mixer (layer {i}, d_inner "
          f"{p['w_in'].shape[1] // 2}, d_state {p['a_log'].shape[1]}): "
          f"prefill {B} x {P} {out[P]:.3f} ms, decode {B} x 1 "
          f"{out[1]:.3f} ms; reading its weights and state once "
          f"{(weights + 2 * state) / HBM_BYTES_PER_S * 1e3:.3f} ms",
          flush=True)


def phase_n(dev, ds_seed: int) -> None:
    """The remaining mixers at their published widths: per model, init,
    the frontend forward, the decode gate, an uncoded serve and the head
    probe; DeepSeek-V3 also served with a coded head."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_model, padded_vocab
    t_phase = time.perf_counter()
    for arch, cut, why in MIXER_MODELS:
        fresh_card(dev, "n")
        cfg = _cut(get_config(arch), cut)
        seed = ds_seed if arch == DEEPSEEK else 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_model(seed, cfg, dev)
        torch.cuda.synchronize()
        serve._MODEL_CACHE[(arch, False, seed, str(dev))] = (cfg, params)
        n_par = sum(t.numel() for t in _leaves(params))
        print(f"[n] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} "
              f"layers ({why}), {cfg.dtype}, {n_par:.4e} parameters, seed "
              f"{seed}; init {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        if cfg.mtp or cfg.frontend is not None:
            _frontend_forward(cfg.name, cfg, params, dev)
        _decode_gate(cfg.name, cfg, params, dev)
        if cfg.mamba is not None:
            _mamba_times(cfg.name, cfg, params, dev)
        B, P, G = MIXER_SERVE
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, size=(B, P))).to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        serve.generate(cfg, params, prompts, 2)              # warm-up
        toks, t_pre, t_dec = serve.generate(cfg, params, prompts, G)
        # greedy over the padded head, as the reference's loop: a random
        # model may pick a padding row
        if toks.shape != (B, G) or (toks < 0).any() or \
                (toks >= padded_vocab(cfg)).any():
            raise AssertionError(f"phase n {cfg.name}: bad tokens {toks}")
        print(f"[n] {cfg.name}: uncoded serve {B} x prompt {P} x gen {G}: "
              f"prefill {B * P / t_pre:.1f} tok/s ({t_pre * 1e3:.1f} ms), "
              f"decode {B * (G - 1) / t_dec:.1f} tok/s ({t_dec * 1e3:.1f} "
              f"ms), peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              f" GiB", flush=True)
        if arch == DEEPSEEK:
            rep = _coded_head(dev, seed, torch.float64, arch=arch,
                              phase="n", twin=True)
            if not rep.decode_ok or rep.argmax_match_rate != 1.0:
                raise AssertionError(
                    f"phase n: the {arch} coded head misses the 5e-4 head "
                    f"tolerance or the uncoded argmax (max_err "
                    f"{rep.max_err:.3e}, argmax match "
                    f"{rep.argmax_match_rate})")
        elif cfg.enc_dec:
            print(f"[n] {cfg.name}: no head probe (the coded bridge serves "
                  f"decoder-only archs, as the reference's)", flush=True)
        else:
            s = max(plan_probe(cfg, 0, scope="head")["head"])
            print(f"[n] {cfg.name}: head probe, seed 0: {s} parity rows of "
                  f"L {padded_vocab(cfg)}"
                  + ("" if cfg.name.startswith("gemma3") else
                     f", float64 minor {8 * s * s / 2**30:.2f} GiB"),
                  flush=True)
        del params
        serve._MODEL_CACHE.clear()
    fresh_card(dev, "n")
    print(f"[n] total {time.perf_counter() - t_phase:.1f} s", flush=True)


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


def _launched(before: dict, phase: str, names) -> dict:
    from repro_torch import kernels
    after = kernels.launch_counts()
    grew = {k: after[k] - before[k] for k in after}
    for k in names:
        if grew[k] <= 0:
            raise AssertionError(f"phase {phase} never launched {k}")
    return grew


def phase_g(dev) -> None:
    """The paper's static coded executor at the paper's size."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import (iterated_greedy, large_scale_scenario,
                                  plan_from_assignment, sca_enhance_plan)
    from repro_torch.obs import Tracer, use_tracer
    from repro_torch.runtime import CodedExecutor
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    # the quickstart's plan: iterated greedy (Alg. 1) -> Theorem-1 loads ->
    # SCA (Alg. 3)
    sc = large_scale_scenario(0)
    plan = sca_enhance_plan(sc, plan_from_assignment(
        sc, iterated_greedy(sc, rng=0)))
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    A = [rng.normal(size=(L_PAPER, L_PAPER)) for _ in range(sc.M)]
    x = [rng.normal(size=L_PAPER) for _ in range(sc.M)]
    t_data = time.perf_counter() - t0
    print(f"[g] executor: M={sc.M} masters, N={sc.N} workers, L={L_PAPER} "
          f"rows x S={L_PAPER} per master, redundancy "
          f"{np.round(plan.l.sum(axis=1) / sc.L, 3).tolist()}, worker "
          f"{EXEC_DEAD} dead; plan {t_plan:.1f} s, host A/x draws "
          f"{t_data:.1f} s", flush=True)
    # traced: the device spans synchronise, so the stage split is honest
    tracer = Tracer(meta={"entry": "chip_smoke", "phase": "g"})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with use_tracer(tracer):
        results, rep = CodedExecutor(sc, plan, rng=2, backend="torch",
                                     device=dev).run(A, x,
                                                     dead_workers=EXEC_DEAD)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    split = {}
    for sp in tracer.spans:
        # the decode is its plan (G upload, gathers) and its apply
        key = {"executor:encode": "encode", "executor:products": "products",
               "plan_decode": "decode", "decode_apply": "decode"}.get(sp.name)
        if key:
            split[key] = split.get(key, 0.0) + sp.dur
    host = wall - sum(split.values())
    print(f"[g] completion ms {np.round(rep.completion, 3).tolist()}, "
          f"prefix nodes {[len(u) for u in rep.used_nodes]}, max_err "
          f"{[float(f'{e:.3e}') for e in rep.max_err]}, decode_ok "
          f"{rep.decode_ok.tolist()}", flush=True)
    print(f"[g] wall {wall:.2f} s: host set-up (G draws, prefixes, "
          f"transfers) {host:.2f} s, encode {split.get('encode', 0):.3f} s, "
          f"products {split.get('products', 0):.3f} s, decode "
          f"{split.get('decode', 0):.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    grew = _launched(before, "g", ("mds_encode", "coded_matvec"))
    print(f"[g] launches {grew}", flush=True)
    for m in range(sc.M):
        if not np.all(np.isfinite(results[m])) or \
                results[m].shape != (L_PAPER,):
            raise AssertionError(f"master {m}: no finite (L,) result")
    if not rep.decode_ok.all():
        raise AssertionError(f"executor decode misses 1e-6: max_err "
                             f"{rep.max_err}")
    del A, x, results
    torch.cuda.empty_cache()


def phase_h(dev) -> None:
    """The streaming engine with verification at the paper's size."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import large_scale_scenario
    from repro_torch.obs import Tracer
    from repro_torch.stream import (BackendConfig, StreamConfig,
                                    StreamingExecutor, WorkerEvent,
                                    poisson_sources)
    sc = large_scale_scenario(0)
    rate = sum(s.rate for s in poisson_sources(sc, utilization=0.5, seed=0))
    span = STREAM_TASKS / rate            # expected arrival span (sim ms)
    churn = [WorkerEvent(0.3 * span, 3, "degrade", 3.0),
             WorkerEvent(0.6 * span, 7, "leave")]

    def run(numerics: str, tracer=None):
        ex = StreamingExecutor(
            sc, poisson_sources(sc, utilization=0.5, seed=0),
            config=StreamConfig(policy="fractional", backend=BackendConfig(
                backend="torch", numerics=numerics)),
            churn=churn, tracer=tracer, device=dev)
        t0 = time.perf_counter()
        s = ex.run(max_tasks=STREAM_TASKS).summary()
        return s, time.perf_counter() - t0

    before = kernels.launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    # traced, for the verification split (tracing runs the per-event
    # drain; the untraced twin runs the batched one -- the delay metrics
    # must agree all the same)
    tracer = Tracer(meta={"entry": "chip_smoke", "phase": "h"})
    s_v, wall_v = run("verify", tracer)
    peak = torch.cuda.max_memory_allocated(dev)
    grew = _launched(before, "h", ("mds_encode", "coded_matvec"))
    split = {"products": 0.0, "decode": 0.0}
    for sp in tracer.spans:
        if sp.cat == "verify":
            split[sp.name.rsplit(":", 1)[-1]] += sp.dur
    s_n, wall_n = run("none")
    keys = ("tasks_completed", "sojourn_p50", "sojourn_p99",
            "queue_wait_mean", "replans")
    print(f"[h] stream: {STREAM_TASKS} tasks, fractional, churn degrade "
          f"w3 x3 at {churn[0].time:.0f} ms + leave w7 at "
          f"{churn[1].time:.0f} ms; verify wall {wall_v:.2f} s (timing-only "
          f"twin {wall_n:.2f} s), peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {grew}", flush=True)
    print(f"[h] verify split: products (G upload + kernels) "
          f"{split['products']:.2f} s, decode {split['decode']:.2f} s, host "
          f"(event loop, G and A draws, row bookkeeping) "
          f"{wall_v - split['products'] - split['decode']:.2f} s",
          flush=True)
    print(f"[h] verify: decode_ok_rate {s_v.get('decode_ok_rate')}; "
          + ", ".join(f"{k} {s_v[k]!r}" for k in keys), flush=True)
    if s_v.get("decode_ok_rate") != 1.0:
        raise AssertionError(f"stream verify decode_ok_rate "
                             f"{s_v.get('decode_ok_rate')}")
    moved = {k: (s_v[k], s_n[k]) for k in keys if s_v[k] != s_n[k]}
    if moved:
        raise AssertionError(f"verification moved the timing: {moved}")


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

    # phase n's coded DeepSeek seed, from the weightless probe (CPU, ~1 s);
    # phase c holds the parity kernels at its solve
    ds_seed, ds_s = deepseek_coded_seed()
    rows = phase_c(dev, ds_s)
    phase_d(dev)
    kernels.reset_launch_counts()
    phase_e(dev)
    phase_f(dev)
    phase_g(dev)
    phase_h(dev)
    phase_j(dev)
    phase_k(dev)
    phase_l(dev)
    phase_m(dev)
    phase_n(dev, ds_seed)
    launches = kernels.launch_counts()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
        rows[name]["launches"] = n
    print(f"[i] total {time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "queued_ms", "library_queued_ms", "graph_ms",
            "library_parity_ms", "two_pass_ms", "batched", "float32",
            "verify", "decode_chunk", "trunk", "deepseek_head",
            "deepseek_chunk", "launch_floor",
            "serving_prefill_bfloat16", "serving_prefill_float32",
            "decode_bfloat16", "decode_float32", "long_prefill_float32")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys
                                   if k in rows[n]}
                                  for n in ("matmul", "coded_matvec",
                                            "mds_encode",
                                            "counter_parity_rows",
                                            "parity_contract",
                                            "gen_parity_matvec", "wkv6")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
