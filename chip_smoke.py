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
     and below the 1e-12 clamp in both types; at edge shapes; row 6t, the
     forward at the train shape B 4 x T 128), and the WKV backward
     (row 6g: against its plain version at the train and long shapes in
     both types with random output and final-state cotangents, the plain
     version against autograd of the chunked forward; against float64
     autograd of the sequential recurrence at the strong decays, with S_0
     and dS_T; at the edge shapes; 16 calls bit-equal; its plan) -- with
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
     each at its main shapes bit-equal; ``coded_matvec``'s wide route
     (more than 8 columns summed in float64, on the FP64 tensor cores) at
     C 9 / 32 / 64 / 65 x K 128 / 2048 / 8192 x 1-24 tiles in both input
     types, 128 rows launched alone bit-equal to the whole launch's, 16
     calls bit-equal; its direct route at 2-8 columns (X read as 16-byte
     vectors, in place or from a [cc][K] copy) bit-equal to the parent's
     element-wise reads over 49 shapes (three type pairs, 1 and 3 tasks,
     K tails, a column-sliced X); row 2t's trunk stages at C = 4 and 32
     with their route, bit-equal to the parent's route and timed beside
     it (P / F); the encode's float32 stream route ``torch.equal`` to the
     copy_prefix + sgemm route at 2^26 + 3 and 2^26 columns, per-task G
     and B > 1; the parity contraction at the trunk decodes (row 3t, C = 4
     and 32, the wide route beside the parent's 8-column launches, P / F)
     and its wide route at C 9-100 gathered and not against its plain
     version, each column of a C = 32 product and 45 of its rows
     computed alone bit-equal to the whole launch's, 16 calls bit-equal;
     ``coded_matvec`` at deepseek-v3-671b's head tiles (L = 129 536, K =
     7 168, C = 4; row 2d, P / F against the parent's direct route) and
     the parity kernels at phase n's frozen DeepSeek solve; the
     blockwise attention forward and backward (rows 7 / 7g) at
     llama3.2-1b's serving prefill, gemma3-12b's windowed 4 096-token
     prefill, DeepSeek-V3's MLA (Dk 192 / Dv 128), phase o's microbatch
     and a 32 768-token prefill, in bf16 (the forward on the tensor cores,
     ``attention_mma``, also against its twin ``ref.attention_mma_ref``,
     with the SIMT kernel timed beside it on the same inputs) and float32
     (SIMT) against the plain versions (forward float32 1e-5, bf16 2^-8 x
     (1 + max |o|), lse 1e-4; gradients float32 1e-4, bf16 2^-7 x (1 +
     max |grad|); windowed rows finite), timed single, queued and from a
     graph beside ``scaled_dot_product_attention`` (forward and
     backward), 16 calls bit-equal, and at 17 edge shapes (Tk = 0 among
     them); then the
     decode's two routes for a parity minor on a synthetic head plan
     whose unknowns are known: the float32 LU refined in float64 at s =
     110 500 parity rows (past the float64 minor's cap), and both routes
     at s = 88 694 (error, sweeps, factor and sweep times, peak memory);
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
     gated on the uncoded twin's tokens; a faulted serve at 2 layers and
     seed 0, whose re-planned head decodes on the refined route;
  m. the paper's Monte Carlo on the card against numpy;
  n. the remaining mixers at their published widths, each model from a
     clean card: deepseek-v3-671b (MLA, MoE, MTP; cut to 2 layers),
     jamba-1.5-large-398b (attention, Mamba, MoE; 3 layers),
     gemma3-12b (sliding-window rings; full depth, a 1 536-token prompt
     that wraps them), dbrx-132b (MoE; 4 layers), internvl2-26b (vision
     frontend) and seamless-m4t-large-v2 (encoder-decoder): init, the
     frontend forward (``mtp_logits``, patches, frames), prefill + decode
     against the full forward at phase j's gate (MoE uncapped), gemma3
     also prefilled at 1 x 4 096 (its windows span several attention
     tiles) with every logit of the full forward finite, for the
     MoE models two same-seed full forwards bit-equal, an uncoded serve
     4 x 32 x 16, and the head probe's parity rows; then
     deepseek-v3-671b served with a coded head (virtual parity, the first
     seed of 0-7 whose frozen head solve's float64 minor is under 30
     GiB), gated at the 5e-4 head tolerance, argmax 1.0 and tokens equal
     to its uncoded twin's;
  s. llama3.2-1b prefilled at its published widths and depth at 1 x
     32 768 tokens (the prefill_32k length) through ``prefill``: tok/s,
     peak GiB, the attention launches (16, one a layer, every one on the
     tensor-core kernel); the logits at
     the last 32 positions finite and within phase j's gate of
     ``model_fwd``'s over the same tokens;
  o. llama3.2-1b trained at its published widths and depth (bf16,
     AdamW, remat, 2 microbatches of 4 x 128 tokens): 6 steps with a
     checkpoint every 3 (step ms, tokens/s, peak memory, each save's and
     the restore's bytes and seconds), gated on the loss falling; the
     step-6 checkpoint dropped and a fresh loop resumed from step 3,
     gated on every param and moment leaf equal to the straight run's
     bit for bit; 2 Adafactor steps (finite loss, peak beside AdamW's);
     the coded gradient
     aggregation (4 groups of 2 rows, 6 shards encoded by the
     ``mds_encode`` kernel's float32 route, 4 arrived) gated against the
     plain float32 sum, its int8 variant printed (row 5g after the
     counts: the stream route equal to the GEMM route on 2^28 columns,
     P / F);
  p. rwkv6-7b trained at its published widths, cut to 8 of its 32
     repeats (bf16, AdamW, remat, phase o's stream and microbatches):
     the memory reckoning at phase o's peak per parameter; 6 steps (step
     ms, tokens/s, peak memory, the WKV forward and backward launches
     checked against 32 and 16 a step), gated on the loss falling; after
     the launch counts are read (its launches compare the kernels), the
     gradient gate (layer 0's time-mix at B 4 x T 128, every parameter's
     gradient through the WKV kernels against autograd of the plain
     chunked WKV) and the remat policies full, dots and none bit-equal
     at 2 repeats;
  q. the sharded forward on torch.distributed: one NCCL rank per visible
     card (spawned), ``make_local_mesh``, parameters as DTensors under the
     sharding rules, ``model_fwd``, ``prefill`` and 3 decode steps at the
     published widths of llama3.2-1b, rwkv6-7b (full depth: the WKV
     kernel under ``local_map``) and dbrx-132b (4 layers: the MoE's
     expert-parallel bodies), held against the unsharded port on the same
     weights (5e-3 x max |logit|, on one card the dense two bit for
     bit; over several cards the bf16 errors printed and the three held
     in float32, dbrx at 2 layers; two sharded runs bit-equal), with
     prefill tokens/s and peak memory beside the unsharded run's;
  r. the analysis tools (after the launch counts are read): r1, the
     dry-run of five production cells (llama3.2-1b train_4k, prefill_32k
     and decode_32k and rwkv6-7b long_500k over 16 x 16 fake ranks,
     deepseek-v3-671b decode_32k over 2 x 16 x 16) on fake CUDA tensors,
     each in a process of its own on the host, started first: their
     roofline terms at one H100's constants, bottleneck, a rank's peak
     GiB, useful ratio and wall time, gated on no allocation on the card
     while tracing; r2, meanwhile on the card, the roofline of phase o's step,
     phase d's prefill and decode step and phase p's step (the analytic
     estimate at MeshDesc(1, 1) and the fake trace's) against their
     measured medians, with mfu, gated on phase o's step: the fake
     trace's FLOPs equal FlopCounterMode's over the same step run for
     real, its peak within 20% of that step's max_memory_allocated; r3,
     the card's bf16 matmul rate at 8192^3 and a 4 GiB copy's bandwidth
     beside the cited peaks;
  i. one JSON line with every kernel's numbers and its launches on the
     main path (phases e to q, counts reset just before e, phase q's
     ranks' added; the wide contraction a row of its own; ``wkv6``'s
     row with its backward's, ``wkv6_bwd`` also a row of its own;
     ``mds_encode`` also timed at phase o's coded-gradient shape, row 5g,
     after the counts are read; ``attention_mma`` (bf16 at head sizes of
     64-256), ``attention`` (the SIMT forward: float32, the smoke configs'
     heads) and ``attention_bwd``, whose launches come from the prefills
     and train steps of phases e to q), then the result line.

Phases j to p start from a clean card (every model and bridge released)
and print the memory still allocated.

Exits non-zero without a result when no CUDA device is visible, or when
the repository's ``src`` is not beside this script.
"""
from __future__ import annotations

import functools
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
BF16_FLOP_PER_S = 989.4e12        # dense bf16 tensor cores
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
#: phase n's long prefill (arch -> tokens): gemma3's 1 024-token windows
#: then span several of the attention kernel's query tiles and key steps
MIXER_LONG = {"gemma3-12b": 4096}
#: phase n's DeepSeek seed: the first of these whose frozen head plan
#: (``plan_probe``, head scope) needs a float64 minor under the limit
MIXER_SEEDS = range(8)
MINOR_LIMIT_GIB = 30.0

#: phase c's WKV shapes (B, H, T): rwkv6-7b's 64 heads of 64
WKV_H, WKV_K = 64, 64
WKV_SHAPES = {"serving prefill": (4, 32), "decode": (4, 1),
              "long prefill": (1, 4096)}

#: phase c's attention shapes: label -> (B, T, Hq, Hkv, D, Dv, window,
#: scale or None for 1 / sqrt(D), backward too): llama3.2-1b's serving
#: prefill (phase d), gemma3-12b's local layers at a 4 096-token prefill
#: (window 1 024: a tile's keys span several of its tiles), DeepSeek-V3's
#: MLA (128 heads, Dk 192 / Dv 128, its scale), phase o's microbatch (4 x
#: 128 tokens, forward and backward), and the prefill_32k length
ATTN_SHAPES = {
    "llama serving prefill": (4, 32, 32, 8, 64, 64, None, None, True),
    "gemma3 windowed": (1, 4096, 16, 8, 256, 256, 1024, None, True),
    "deepseek MLA": (4, 32, 128, 128, 192, 128, None, 192 ** -0.5, True),
    "train microbatch": (4, 128, 32, 8, 64, 64, None, None, True),
    "llama prefill 32k": (1, 32768, 32, 8, 64, 64, None, None, False),
}
#: the shapes whose numbers stand in the JSON line's rows
ATTN_ROW, ATTN_BWD_ROW = "llama prefill 32k", "train microbatch"
#: the new phase: llama3.2-1b prefilled at the prefill_32k length, and the
#: positions whose logits are held against ``model_fwd``'s
LONG_PREFILL, LONG_TAIL = 32768, 32
#: the phase's wall-time budget, seconds
LONG_PREFILL_BUDGET = 60.0

#: phase o: llama3.2-1b trained at its published widths and depth (bf16),
#: on the launcher's default stream and the loop of the coded-training
#: example, a checkpoint every 3 steps.  The peak lr is 1e-4, not the
#: launcher's smoke-size 3e-3: with 1 024 tokens a step and a 5-step
#: warmup, Adam's first updates move every weight by about the lr, and at
#: 3e-3 or 3e-4 the full-width loss rises again after the first update,
#: in float32 as in bf16 (``tools/train_lr_probe.py`` prints each curve)
TRAIN_STREAM = dict(seq_len=128, global_batch=8, seed=0)
TRAIN_LOOP = dict(total_steps=6, ckpt_every=3, n_microbatches=2,
                  lr_peak=1e-4, warmup=5, keep=2, log_every=1)
ADAFACTOR_STEPS = 2
#: phase o's coded gradient aggregation (examples/coded_training.py): k
#: groups of the step's rows, n coded shards, the shards that arrive
GRAD_K, GRAD_N, GRAD_ARRIVED, GRAD_RNG = 4, 6, (0, 2, 4, 5), 1
#: the aggregate against the plain float32 sum of the k trees, per leaf,
#: relative to the leaf's largest entry: the arrived rows combined by the
#: weights of a float32 4 x 4 solve with [e0; e2; R0; R1] (1.8e-7 on the
#: CPU test's trees, tests/test_torch_train.py::
#: test_coded_grads_match_reference)
GRAD_TOL = 1e-5
#: phase p: rwkv6-7b trained at its published widths, cut to 8 of its 32
#: repeats (the eager AdamW step's memory: phase o's peak per parameter
#: puts the full depth at ~185 GiB), bf16, the stream and step of
#: phase o (2 microbatches of 4 x 128 tokens, AdamW, warmup 5, remat
#: "full").  The peak lr is 3e-5: ``tools/train_lr_probe.py --arch
#: rwkv6-7b --repeats 8`` shows the loss falling at every step but the
#: last at 3e-5, while at 1e-4 it rises again at steps 3 and 5 and at
#: 3e-4 and 3e-3 it climbs far above its start
RWKV_TRAIN_CUT = {"n_repeats": 8}
RWKV_TRAIN_STEPS = 6
RWKV_TRAIN_LR = 3e-5
#: the gradient gate (layer 0's time-mix, B 4 x T 128, bf16): each
#: parameter's gradient through the kernels against the same loss through
#: autograd of the plain chunked WKV, in relative L2 over the leaf -- the
#: two WKV forwards round their outputs to bf16 apart (the kernel's
#: products on TF32), and every bf16 rounding on the path after moves a
#: value by up to 2^-9
RWKV_GRAD_TOL = 1e-2
#: the remat gate's depth
RWKV_REMAT_REPEATS = 2
#: phase c's decode-route cases: a synthetic head decode (L_HEAD columns,
#: s parity rows, the pinned values zero) whose unknowns are known: the
#: refined route at the head size phase l's faulted serve re-planned to at
#: seed 0 (PR 19: ~110 500 rows, 91.05 GiB in float64), and both routes at
#: phase e's largest float64 solve
REFINED_S = 110_500
F64_S = 88_694
#: the refined decode against the known unknowns, relative to max |z|
ROUTE_TOL = 1e-9
#: phase q: the sharded forward on torch.distributed, one NCCL rank per
#: visible card over ("data", "model") = (1, cards), at the published
#: widths: (arch, the depth cut or None, why), MoE uncapped
MESH_MODELS = (
    (ARCH, None, "not cut"),
    (RWKV, None, "not cut (the WKV kernel under the mesh)"),
    ("dbrx-132b", dict(n_repeats=4), "40 -> 4 layers, phase n's cut"),
)
#: phase q over several cards: the models again in float32 (dbrx cut to 2
#: layers: its float32 weights and their shards share one card)
MESH_F32 = ((ARCH, None, "float32"), (RWKV, None, "float32"),
            ("dbrx-132b", dict(n_repeats=2), "float32, 40 -> 2 layers"))
#: phase q's batch, prompt and decode steps
MESH_RUN = (4, 32, 3)
#: phase q's gate, x max |logit| (the reference's sharded test's); on one
#: card the dense models must also be bit-equal
MESH_TOL = 5e-3
#: phase r1: production cells (arch, shape cell, two pods) traced on fake
#: CUDA tensors over torch's fake process group of 256 / 512 ranks, each
#: in a process of its own, all started together (the traces run on the
#: host: the card holds no tensor of theirs)
R1_CELLS = (("llama3.2-1b", "train_4k", False),
            ("llama3.2-1b", "prefill_32k", False),
            ("llama3.2-1b", "decode_32k", False),
            ("rwkv6-7b", "long_500k", False),
            ("deepseek-v3-671b", "decode_32k", True))
R1_TIMEOUT = 600
#: phase r2's gate: the fake trace's peak bytes against the real step's
#: ``max_memory_allocated``, relative
R2_PEAK_TOL = 0.2
#: phase r3: the bf16 matmul's side and the device-to-device copy's bytes
R3_MATMUL = 8192
R3_COPY_BYTES = 4 * 2**30


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


def in_turns(timer, fa, fb, rounds: int = 4) -> tuple:
    """``timer`` of ``fa`` and of ``fb`` taken in turns (a b b a a b ...),
    the median of each: a card that warms under load slows both alike."""
    a, b = [], []
    for r in range(rounds):
        for f, out in ((fa, a), (fb, b)) if r % 2 == 0 else \
                ((fb, b), (fa, a)):
            out.append(timer(f))
    a.sort()
    b.sort()
    return a[len(a) // 2], b[len(b) // 2]


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
    print_matvec_plan("serving shape", flat, x, torch.float64)
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
    print_matvec_plan("batched executor shape", at, xb[..., None],
                      torch.float64)
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
    # wider than 8 columns: one counted launch of the wide route (float64
    # sums), two 8-column launches for float32 sums
    from repro_torch.kernels import coded_matvec as cmv
    a12 = at[0, :4096]
    x12 = torch.randn((Lp, 12), generator=gen, device=dev,
                      dtype=torch.float64)
    n0 = cmv.LAUNCHES
    got = cmv.coded_matvec_cuda(a12, x12)
    n12 = cmv.LAUNCHES - n0
    err12 = max_err(got, ref.coded_matvec_ref(a12, x12))
    a32, x32 = a12.float(), x12.float()
    n0 = cmv.LAUNCHES
    got32 = cmv.coded_matvec_cuda(a32, x32)
    n32 = cmv.LAUNCHES - n0
    err32 = max_err(got32, ref.coded_matvec_ref(a32, x32))
    tol32 = 2e-3 * (1 + float(got32.abs().max()))
    print(f"[c] coded_matvec 12 columns: float64 {n12} launch "
          f"({matvec_route(a12, x12)}), max_abs_err={err12:.3e}; float32 "
          f"{n32} launches ({matvec_route(a32, x32)}), max_abs_err="
          f"{err32:.3e}", flush=True)
    if n12 != 1 or err12 > tol or n32 != 2 or err32 > tol32:
        raise AssertionError("coded_matvec at 12 columns")
    del at, xb, got, want, a12, x12, a32, x32, got32
    torch.cuda.empty_cache()
    coded_matvec_edge_sweep(dev)
    wide_matvec_gates(dev)
    direct_matvec_gates(dev)

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

    stream_encode_gates(dev)

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
    trunk = trunk_contract_rows(dev, gen, key)
    rows["parity_contract"]["trunk"] = {k: v for k, v in trunk.items()
                                        if v["route"] == "narrow"}
    wide_contract_gates(dev, key)
    # the wide contraction's row: row 3t at L 8192, C = 32, beside its
    # other trunk shapes
    wide = {k: v for k, v in trunk.items() if v["route"] == "wide"}
    main = wide[f"L={TRUNK_DECODES[-1][0]} s={TRUNK_DECODES[-1][1]} "
                f"C={TRUNK_COLS[-1]}"]
    rows["parity_contract_wide"] = dict(
        name="parity_contract_wide", route="cuda",
        source="src/repro_torch/csrc/mds_encode.cu",
        replaces="src/repro/kernels/mds_encode.py:65",
        max_abs_err=max(v["max_abs_err"] for v in wide.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        queued_ms=main["queued_ms"], graph_ms=main["graph_ms"], trunk=wide)
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
    rows["wkv6"].update(wkv6_bwd_rows(dev, report))
    attn = attention_rows(dev, report)
    for name, route in (("attention_mma", "mma"), ("attention", "simt")):
        rows[name]["shapes"] = {k: v for k, v in attn["shapes"].items()
                                if v["route"] == route}
    rows["attention_bwd"]["shapes"] = attn["backward"]
    return rows


def _attn_inputs(dev, B, T, Hq, Hkv, D, Dv, dt, seed=0):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    return n(B, T, Hq, D), n(B, T, Hkv, D), n(B, T, Hkv, Dv)


def _attn_pairs(B, T, window) -> int:
    from repro_torch.kernels.plan import attention_masked_pairs
    return B * attention_masked_pairs(T, T, True, window)


def _attn_bound(B, T, Hq, Hkv, D, Dv, window, esz, backward=False):
    """Least time of the attention at a shape: the exact masked pairs'
    operations -- the forward's two products, 2 (D + Dv) a pair; the
    backward's four, 2 (2 D + 2 Dv) -- at the bf16 tensor cores' 989.4
    TFLOP/s (float32 inputs at the FP32 pipe's 67), against q, k, v, o
    (and for the backward lse, do read and dq, dk, dv written) once each
    at 3.35 TB/s."""
    pairs = Hq * _attn_pairs(B, T, window)
    ops = 2.0 * pairs * ((2 * D + 2 * Dv) if backward else (D + Dv))
    rate = BF16_FLOP_PER_S if esz == 2 else F32_FLOP_PER_S
    q, kv, o = B * T * Hq * D, B * T * Hkv * (D + Dv), B * T * Hq * Dv
    nbytes = esz * (q + kv + o)
    if backward:
        nbytes += esz * (o + q + kv) + 4 * B * Hq * T
    return bound(nbytes, [ops / rate])


def _sdpa(q, k, v, window, scale, grad=False):
    """The library's same work: ``scaled_dot_product_attention`` on (B, H,
    T, D) views, GQA by ``enable_gqa``, causal, a boolean mask for the
    window (timed beside the kernel, never called by the port).  Returns
    the call and its (B, H, T, D) inputs (leaves that require grad when
    ``grad``)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(grad)
                  for t in (q, k, v))
    kw = dict(enable_gqa=True, scale=scale)
    if window is None:
        kw["is_causal"] = True
    else:
        i = torch.arange(q.shape[1], device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & \
            (i[None, :] > i[:, None] - window)
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)), \
        (qt, kt, vt)


#: phase c's attention edge shapes, float32 and bf16, forward and backward
#: against the plain versions: (B, Tq, Tk, Hq, Hkv, D, Dv, causal, window,
#: q_offset, kv_valid): G = 6, 64 (one head position a tile) and 128 (two
#: head chunks), Tq != Tk non-causal with Dv > D, a q_offset with a (B,)
#: kv_valid (one row seeing few keys), a ragged windowed T with Dv < D,
#: head sizes below their compiled width (the smoke configs' 16, their
#: MLA's 24 / 16, 192 / 128's padding to 192), one key; then shapes for the
#: tensor-core route's steps and tiles (bf16): G = 1 at 64 with a window
#: across its 96-key steps, G = 6 at 128 with a ragged T (21 positions a
#: tile), MLA's 192 / 128 with a q_offset and Tq != Tk, G = 16 at 256 with
#: a window across its 64-key steps, no keys at all (Tk = 0: rows of 0,
#: log-sum-exp -inf, no loads), non-causal Tq != Tk with a (B,) kv_valid
ATTN_EDGES = ((2, 40, 40, 4, 2, 16, 16, True, None, 0, None),
              (2, 33, 33, 4, 4, 24, 16, True, None, 0, None),
              (2, 37, 37, 6, 1, 128, 128, True, None, 0, None),
              (1, 33, 33, 64, 1, 64, 64, True, None, 0, None),
              (1, 20, 20, 128, 1, 64, 64, True, None, 0, None),
              (1, 50, 83, 4, 2, 64, 256, False, None, 0, None),
              (2, 19, 70, 16, 1, 64, 64, True, None, 51, (70, 3)),
              (1, 200, 200, 2, 1, 256, 64, True, 33, 0, None),
              (3, 64, 64, 8, 8, 192, 192, True, 7, 0, None),
              (2, 45, 45, 4, 4, 128, 192, False, 9, 0, None),
              (1, 9, 1, 2, 1, 64, 64, False, None, 0, None),
              (1, 300, 300, 2, 2, 64, 64, True, 200, 0, None),
              (2, 150, 150, 12, 2, 128, 128, True, None, 0, None),
              (2, 40, 90, 4, 4, 192, 128, True, None, 50, None),
              (1, 260, 260, 32, 2, 256, 256, True, 100, 0, None),
              (2, 7, 0, 4, 2, 128, 128, False, None, 0, None),
              (1, 24, 200, 6, 1, 64, 64, False, None, 0, (150,)))


def attention_edge_sweep(dev) -> None:
    """The attention kernels at ATTN_EDGES in both types against the plain
    versions, at attention_rows' tolerances (the log-sum-exp at 1e-4, its
    -inf rows alike); where the tensor-core kernel runs, also against its
    twin; every output finite."""
    import torch
    from repro_torch.kernels import attention as ka, ref
    worst, mma = 0.0, 0
    for (B, Tq, Tk, Hq, Hkv, D, Dv, causal, window, q_off, kv) in ATTN_EDGES:
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(Tq + Tk + D)

            def n(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dt)
            q, k, v = n(B, Tq, Hq, D), n(B, Tk, Hkv, D), n(B, Tk, Hkv, Dv)
            do = n(B, Tq, Hq, Dv)
            kvt = None if kv is None else torch.tensor(
                kv, dtype=torch.int32, device=dev)
            sc = D ** -0.5
            route = ka.attention_route(dt, D, Dv)
            mma += route == "mma"
            out, lse = ka.attention_cuda(q, k, v, kvt, causal, window, q_off,
                                         sc)
            grads = ka.attention_bwd_cuda(q, k, v, out, lse, do, kvt, causal,
                                          window, q_off, sc)
            kw = dict(causal=causal, window=window, q_offset=q_off,
                      kv_valid=kvt, scale=sc)
            if Tk:
                want, want_lse = ref.attention_ref(q, k, v, **kw)
                want_g = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
            else:       # no keys: rows of 0, no gradient
                want = torch.zeros_like(out)
                want_lse = torch.full_like(lse, -float("inf"))
                want_g = [torch.zeros_like(t) for t in (q, k, v)]
            pairs = [("lse", lse, want_lse)]
            if route == "mma":
                tw, tw_lse = ref.attention_mma_ref(q, k, v, **kw)
                pairs += [("lse against the twin", lse, tw_lse)]
            torch.cuda.synchronize()
            f32 = dt == torch.float32
            tag = (f"attention edge B {B} Tq {Tq} Tk {Tk} Hq {Hq} Hkv {Hkv} "
                   f"D {D} Dv {Dv} causal {causal} window {window} "
                   f"q_offset {q_off} kv_valid {kv} {dt} ({route})")
            for nm, g, w in pairs:
                fin = torch.isfinite(w)
                if not torch.equal(fin, torch.isfinite(g)) or (
                        fin.any() and max_err(g[fin], w[fin]) > 1e-4):
                    raise AssertionError(f"{tag} {nm}: finite rows differ "
                                         f"or err > 1e-4")
            checks = [("out", out, want, 1e-5 if f32 else 2.0 ** -8)]
            if route == "mma":
                checks.append(("out against the twin", out, tw, 2.0 ** -8))
            checks += [(nm, g, w, 1e-4 if f32 else 2.0 ** -7) for nm, g, w
                       in zip(("dq", "dk", "dv"), grads, want_g)]
            for nm, g, w, step in checks:
                e = max_err(g, w) if g.numel() else 0.0
                t = step * (1 + (float(w.float().abs().max())
                                 if w.numel() else 0.0))
                if e > t or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{tag} {nm}: {e} > {t}")
                worst = max(worst, e / t)
    print(f"[c] attention: {len(ATTN_EDGES)} edge shapes x 2 types ({mma} "
          f"calls on the tensor cores), forward and backward, agree with "
          f"the plain versions (largest err / tol {worst:.3g})", flush=True)


def attention_rows(dev, report) -> dict:
    """The attention kernels against their plain versions
    (``ref.attention_ref`` / ``ref.attention_bwd_ref`` over the
    reference's 512 blocks) at ATTN_SHAPES: the forward in bf16 (the path:
    the tensor-core kernel, ``attention_mma``, also held to its twin
    ``ref.attention_mma_ref``, and the SIMT kernel on the same inputs) and
    float32 (SIMT), the backward where the shape has one, each timed
    single, queued and from a CUDA graph beside the library's same work
    (the tensor-core forward and the library in turns, medians of four);
    windowed rows finite; 16 forward calls bit-equal and 16 backward calls
    bit-equal.  Returns the per-shape numbers for the JSON line's rows.

    Tolerances, relative to 1 + max |plain|: the forward in float32 1e-5
    (one online softmax in float32, sums in another order and other
    tiles); in bf16 2^-8 (both round a float32 result to bf16; the
    tensor-core kernel's P is two bf16 parts, 2^-17 of P), the same
    against the twin; lse 1e-4; the gradients in float32 1e-4 (four
    products and the recomputed P, sums over up to T terms in another
    order), in bf16 2^-7 (a bf16 step at the largest entry)."""
    import torch
    from repro_torch.kernels import attention as ka, ref
    from repro_torch.kernels.plan import attention_mma_plan, attention_plan
    fwd_rows, bwd_rows = {}, {}
    for label, (B, T, Hq, Hkv, D, Dv, window, scale, bwd) in \
            ATTN_SHAPES.items():
        sc = D ** -0.5 if scale is None else scale
        p = attention_plan(D, Dv, Hq // Hkv, 2)
        pm = attention_mma_plan(D, Dv, Hq // Hkv)
        print(f"[c] plan attention {label} B {B} T {T} Hq {Hq} Hkv {Hkv} D "
              f"{D} Dv {Dv}{f' window {window}' if window else ''}: "
              f"tensor cores {pm.dc} / {pm.vc} chunks of 64, {pm.rows} rows "
              f"({pm.gt} heads x {pm.bq} positions) a tile, {pm.bk} keys a "
              f"stage, {pm.stages} stages, {pm.threads} threads "
              f"({pm.consumer_regs} registers a consumer), "
              f"{pm.blocks(B, T, Hkv, Hq // Hkv)} blocks, {pm.smem_bytes} B "
              f"shared; SIMT width {p.width}, "
              f"{p.gt} heads x {p.bq} positions a tile, {p.bk} keys a step, "
              f"grid {p.grid(B, T, Hkv, Hq // Hkv)}, {p.smem_bytes} B "
              f"shared, {p.blocks_per_sm} an SM; dQ {p.dq_smem} B, "
              f"{p.dq_blocks_per_sm} an SM; dK / dV {p.bn} keys a block, "
              f"grid {p.dkdv_grid(B, T, Hkv)}, {p.dkdv_smem} B, "
              f"{p.dkdv_blocks_per_sm} an SM", flush=True)
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            tag = f"attention {label} {name}"
            q, k, v = _attn_inputs(dev, B, T, Hq, Hkv, D, Dv, dt)
            route = ka.attention_route(dt, D, Dv)

            def call(route=None):
                return ka.attention_cuda(q, k, v, None, True, window, 0, sc,
                                         route=route)

            def plain():
                return ref.attention_ref(q, k, v, window=window, scale=sc)
            out, lse = call()
            plain_ms, (want, want_lse) = time_once(plain)
            top = 1 + float(want.float().abs().max())
            tol = (2.0 ** -8 if dt == torch.bfloat16 else 1e-5) * top
            err = max_err(out, want)
            lse_err = max_err(lse, want_lse)
            finite = bool(torch.isfinite(out).all())
            if err > tol or lse_err > 1e-4 or not finite:
                raise AssertionError(f"{tag}: kernel ({route}) disagrees "
                                     f"with its plain version (out {err} > "
                                     f"{tol}, lse {lse_err}, finite "
                                     f"{finite})")
            nums = dict(route=route, max_abs_err=err, tol=tol,
                        lse_err=lse_err, plain_ms=plain_ms)
            if dt == torch.bfloat16:
                twin_ms, (tw, tw_lse) = time_once(
                    lambda: ref.attention_mma_ref(q, k, v, window=window,
                                                  scale=sc))
                twin_err, twin_lse = max_err(out, tw), max_err(lse, tw_lse)
                if twin_err > tol or twin_lse > 1e-4:
                    raise AssertionError(f"{tag}: the tensor-core kernel "
                                         f"disagrees with its twin (out "
                                         f"{twin_err} > {tol}, lse "
                                         f"{twin_lse})")
                del tw, tw_lse
                simt_out, simt_lse = call("simt")
                simt_err = max_err(simt_out, want)
                simt_lse_err = max_err(simt_lse, want_lse)
                if simt_err > tol or simt_lse_err > 1e-4:
                    raise AssertionError(f"{tag}: the SIMT kernel disagrees "
                                         f"({simt_err} > {tol}, lse "
                                         f"{simt_lse_err})")
                del simt_out, simt_lse
                if label == ATTN_ROW:
                    repeat_equal(f"{tag} out", out, lambda: call()[0])
                    repeat_equal(f"{tag} lse", lse, lambda: call()[1])
                simt = functools.partial(call, "simt")
                simt_g = time_graph_ms(simt, 5)
                # the kernel and the library in turns, single and from a
                # graph
                lib, _ = _sdpa(q, k, v, window, sc)
                ms, lib_ms = in_turns(lambda f: time_ms(f, 10), call, lib)
                g_ms, lib_g = in_turns(lambda f: time_graph_ms(f, 5), call,
                                       lib)
                q_ms = time_queued_ms(call, 10)
                lib_err = max_err(lib().transpose(1, 2), want)
                bnd = _attn_bound(B, T, Hq, Hkv, D, Dv, window, 2)
                nums.update(ms=ms, queued_ms=q_ms, graph_ms=g_ms,
                            simt_graph_ms=simt_g, library_ms=lib_ms,
                            library_graph_ms=lib_g, bound_ms=bnd[0],
                            bound_by=bnd[1], twin_err=twin_err,
                            twin_lse_err=twin_lse, twin_ms=twin_ms,
                            simt_err=simt_err)
                print(f"[c] {tag}: tensor cores max_abs_err={err:.3e} (tol "
                      f"{tol:.3e}), lse {lse_err:.3e}, against the twin "
                      f"{twin_err:.3e} (lse {twin_lse:.3e}), finite; SIMT "
                      f"{simt_err:.3e}; kernel {ms:.4f} ms single, "
                      f"{q_ms:.4f} queued, {g_ms:.4f} from a graph; SIMT "
                      f"{simt_g:.4f} from a graph; plain {plain_ms:.2f} ms, "
                      f"twin {twin_ms:.2f} ms; library {lib_ms:.4f} ms "
                      f"single, {lib_g:.4f} from a graph (its error "
                      f"{lib_err:.3e}); bound {bnd[0]:.4f} ms ({bnd[1]}), "
                      f"graph / bound {g_ms / bnd[0]:.2f}, graph / library "
                      f"graph {g_ms / lib_g:.2f}, SIMT / tensor cores "
                      f"{simt_g / g_ms:.2f}", flush=True)
                if label == ATTN_ROW:
                    report("attention_mma",
                           "src/repro_torch/csrc/attention_mma.cu",
                           "src/repro/models/attention.py:72", err, tol, ms,
                           plain_ms, lib_ms, bnd, queued_ms=q_ms,
                           graph_ms=g_ms, library_graph_ms=lib_g,
                           simt_graph_ms=simt_g)
                    # the SIMT kernel's row: the same inputs, its parent's
                    # figure (its main-path calls are float32 and the
                    # smoke configs' heads)
                    report("attention", "src/repro_torch/csrc/attention.cu",
                           "src/repro/models/attention.py:72", simt_err,
                           tol, time_ms(simt, 3), plain_ms, lib_ms, bnd,
                           queued_ms=time_queued_ms(simt, 3),
                           graph_ms=simt_g)
            else:
                print(f"[c] {tag}: max_abs_err={err:.3e} (tol {tol:.3e}), "
                      f"lse {lse_err:.3e}, finite; plain {plain_ms:.2f} ms",
                      flush=True)
            fwd_rows[f"{label} {name}".replace(" ", "_")] = nums
            if bwd:
                bwd_rows[f"{label} {name}".replace(" ", "_")] = \
                    _attention_bwd_row(dev, report, tag, label, q, k, v,
                                       out, lse, window, sc, dt)
            del q, k, v, out, lse, want, want_lse
            torch.cuda.empty_cache()
    attention_edge_sweep(dev)
    return {"shapes": fwd_rows, "backward": bwd_rows}


def _attention_bwd_row(dev, report, tag, label, q, k, v, out, lse, window,
                       sc, dt) -> dict:
    """The backward kernels at one shape against ``ref.attention_bwd_ref``
    on the same forward output, log-sum-exp and a random cotangent."""
    import torch
    from repro_torch.kernels import attention as ka, ref
    B, T, Hq, D = q.shape
    Hkv, Dv = v.shape[2], v.shape[3]
    gen = torch.Generator(device=dev).manual_seed(7)
    do = torch.randn(out.shape, generator=gen, device=dev).to(dt)

    def call():
        return ka.attention_bwd_cuda(q, k, v, out, lse, do, None, True,
                                     window, 0, sc)
    got = call()
    plain_ms, want = time_once(lambda: ref.attention_bwd_ref(
        q, k, v, out, lse, do, window=window, scale=sc))
    step = 2.0 ** -7 if dt == torch.bfloat16 else 1e-4
    errs = []
    for nm, g, w in zip(("dq", "dk", "dv"), got, want):
        e, t = max_err(g, w), step * (1 + float(w.float().abs().max()))
        if e > t or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} backward {nm}: {e} > {t}")
        errs.append((nm, e, t))
    name = str(dt).split(".")[-1]
    nums = dict(errors={nm: e for nm, e, _ in errs}, plain_ms=plain_ms)
    if dt == torch.bfloat16:
        repeat_equal(f"{tag} backward dk", got[1], lambda: call()[1])
        ms = time_ms(call, 10)
        q_ms = time_queued_ms(call, 10)
        g_ms = time_graph_ms(call, 5)
        # the library's same work: SDPA's backward through autograd on
        # the same inputs and cotangent (its forward timed apart)
        lib, leaves = _sdpa(q, k, v, window, sc, grad=True)
        o_lib = lib()
        do_t = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o_lib, leaves, do_t, retain_graph=True), 10)
        bnd = _attn_bound(B, T, Hq, Hkv, D, Dv, window, 2, backward=True)
        nums.update(ms=ms, queued_ms=q_ms, graph_ms=g_ms, library_ms=lib_ms,
                    bound_ms=bnd[0], bound_by=bnd[1])
        print(f"[c] {tag} backward: "
              + ", ".join(f"{nm} {e:.3e} (tol {t:.3e})" for nm, e, t in errs)
              + f"; kernels {ms:.4f} ms single, {q_ms:.4f} queued, "
              f"{g_ms:.4f} from a graph; plain {plain_ms:.2f} ms; library "
              f"backward {lib_ms:.4f} ms; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), graph / bound {g_ms / bnd[0]:.2f}", flush=True)
        if label == ATTN_BWD_ROW:
            e, t = max(((e, t) for _, e, t in errs),
                       key=lambda x: x[0] / x[1])
            report("attention_bwd", "src/repro_torch/csrc/attention_bwd.cu",
                   "src/repro/models/attention.py:72", e, t, ms, plain_ms,
                   lib_ms, bnd, queued_ms=q_ms, graph_ms=g_ms)
        del leaves, o_lib
    else:
        print(f"[c] {tag} backward: "
              + ", ".join(f"{nm} {e:.3e} (tol {t:.3e})" for nm, e, t in errs)
              + f"; plain {plain_ms:.2f} ms", flush=True)
    del got, want, do
    return nums


class _SynthHead:
    """What a decode member reads of a coded head: its parity key, width L,
    device and parity counters (draw 0)."""

    def __init__(self, dev):
        self.pkey, self.L, self.device = (0x1234ABCD, 0x9E3779B8), L_HEAD, dev

    def parity_ctrs(self, ids):
        from repro_torch.core import mds
        return mds.parity_counters(np.asarray(ids), 0)


def _synthetic_decode(dev, s: int, budget=None) -> dict:
    """Decode a synthetic head plan of ``s`` parity rows whose unknowns z
    are known (y = R[par, unk] @ z in float64 from the contraction
    kernel; the L - s pinned values zero) through the serving decode's
    member solve, with ``packing.MINOR_BUDGET`` = ``budget``."""
    import torch
    from repro_torch.serve_coded import packing
    lin = _SynthHead(dev)
    rng = np.random.default_rng(s)
    unk = np.sort(rng.permutation(L_HEAD)[:s])
    known = np.setdiff1d(np.arange(L_HEAD), unk)
    member = packing._DeviceMember(
        lin, np.concatenate([known, L_HEAD + np.arange(s)]))
    gen = torch.Generator(device=dev).manual_seed(s)
    z = torch.randn((s, BATCH), generator=gen, dtype=torch.float64,
                    device=dev)
    y = torch.zeros((L_HEAD, BATCH), dtype=torch.float64, device=dev)
    y[known.size:] = member._minor_product(z)
    out = torch.empty_like(y)
    saved, packing.MINOR_BUDGET = packing.MINOR_BUDGET, budget
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        route = packing.minor_route(s, dev)
        t0 = time.perf_counter()
        member.factor(route)
        torch.cuda.synchronize()
        t_factor = time.perf_counter() - t0
        sweeps0 = len(packing.SWEEPS)
        t0 = time.perf_counter()
        member.solve(y, out)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
    finally:
        packing.MINOR_BUDGET = saved
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    sweeps = packing.SWEEPS[sweeps0] if route == "refined" else 0
    contract_ms = time_ms(lambda: member._minor_product(z), 3)
    from repro_torch.stream import backend as bk
    lu_ms = time_ms(lambda: bk.lu_solve_torch(member.lu, z.to(
        member.lu[0].dtype)), 3)
    err = max_err(out[torch.from_numpy(unk).to(dev)], z) \
        / float(z.abs().max())
    res = dict(s=s, route=route, err=err, sweeps=sweeps,
               factor_s=t_factor, solve_ms=1e3 * t_solve,
               contract_ms=contract_ms, lu_solve_ms=lu_ms, peak_gib=peak,
               z=out[torch.from_numpy(unk).to(dev)].cpu())
    print(f"[c] decode route {route} at s = {s} (L {L_HEAD}, {BATCH} "
          f"columns): max |z - z_true| / max |z| {err:.3e} (tol "
          f"{ROUTE_TOL:.0e}); minor build + factor {t_factor:.2f} s, first "
          f"solve {1e3 * t_solve:.1f} ms with {sweeps} refinement sweeps "
          f"(a sweep: the minor's float64 product {contract_ms:.2f} ms + an "
          f"LU solve {lu_ms:.2f} ms), peak {peak:.2f} GiB", flush=True)
    del member, out, y
    gc.collect()
    torch.cuda.empty_cache()
    if not np.isfinite(err):
        raise AssertionError(f"decode route {route} at s = {s}: {err}")
    return res


def decode_route_rows(dev) -> None:
    """Phase c's decode-route cases: the refined route past the float64
    minor's cap (s = REFINED_S), and both routes at F64_S, the float64
    one by size, the refined one by a lowered budget.  The refined route
    must decode the known unknowns within ROUTE_TOL at both sizes, and at
    F64_S no less exactly than the float64 LU, whose own error is
    printed beside it (an LU's backward error grows with s: it is not
    held to ROUTE_TOL)."""
    big = _synthetic_decode(dev, REFINED_S)
    f64 = _synthetic_decode(dev, F64_S)
    ref = _synthetic_decode(dev, F64_S, budget=8 * F64_S ** 2 - 1)
    agree = max_err(ref["z"], f64["z"]) / float(f64["z"].abs().max())
    print(f"[c] decode routes at s = {F64_S}: refined against float64 "
          f"{agree:.3e}, against the known z {ref['err']:.3e} and "
          f"{f64['err']:.3e}; factor {ref['factor_s']:.2f} s against "
          f"{f64['factor_s']:.2f} s, first solve {ref['solve_ms']:.1f} ms "
          f"against {f64['solve_ms']:.1f} ms, peak {ref['peak_gib']:.2f} "
          f"against {f64['peak_gib']:.2f} GiB", flush=True)
    if (big["route"], f64["route"], ref["route"]) != ("refined", "float64",
                                                     "refined"):
        raise AssertionError(f"decode routes: {big['route']} at s = "
                             f"{REFINED_S}, {f64['route']} and "
                             f"{ref['route']} at s = {F64_S}")
    if max(big["err"], ref["err"]) > ROUTE_TOL or ref["err"] > f64["err"]:
        raise AssertionError(f"the refined decode missed the known z: "
                             f"{big['err']} at s = {REFINED_S}, "
                             f"{ref['err']} at s = {F64_S} (float64 LU "
                             f"{f64['err']})")


def pf_turns(parent, change, iters: int = 9) -> dict:
    """The parent's and the change's call on the same inputs, timed in
    turns P F F P, each turn single (median of ``iters``), queued and from
    a CUDA graph: the lower of each kind's two turns."""
    turns = {"P": [], "F": []}
    for who in "PFFP":
        fn = parent if who == "P" else change
        turns[who].append((time_ms(fn, iters), time_queued_ms(fn),
                           time_graph_ms(fn)))
    ms, q_ms, g_ms = (min(v[i] for v in turns["F"]) for i in range(3))
    p_ms, p_q_ms, p_g_ms = (min(v[i] for v in turns["P"]) for i in range(3))
    return dict(ms=ms, queued_ms=q_ms, graph_ms=g_ms, parent_ms=p_ms,
                parent_queued_ms=p_q_ms, parent_graph_ms=p_g_ms)


def trunk_matvec_rows(dev, gen) -> dict:
    """``coded_matvec`` at phase l's packed trunk stages (ragged stage
    rows in 128-row tiles, K up to 8192), float64 sums, against its plain
    version and (bit for bit) the parent's direct route (``route=
    "element"``; the staged and wide shapes run the same launches on
    both); each row's route, and the wrapper's time beside the parent's
    through the same wrapper on the same inputs, as P / F, timed in turns
    P F F P; beside them the main path's entry
    (``ops.coded_shard_matmul_batch``, whose host work a single call also
    times) and the library call."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
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
            old = coded_matvec_cuda(flat, x, out_dtype=torch.float64,
                                    route="narrow")
            if max_err(old, want) > tol:
                raise AssertionError(f"coded_matvec's 8-column launches at "
                                     f"the trunk stage {stage} disagree")

            def parent():
                return coded_matvec_cuda(flat, x, out_dtype=torch.float64,
                                         route="element")

            def change():
                return coded_matvec_cuda(flat, x, out_dtype=torch.float64)
            if not torch.equal(parent(), got):
                raise AssertionError(f"coded_matvec at the trunk stage "
                                     f"{stage}, C {C}: not bit-equal to the "
                                     f"parent's route")
            row = dict(route=matvec_route(flat, x, torch.float64),
                       **pf_turns(parent, change))
            row.update(
                ops_ms=time_ms(lambda: ops.coded_shard_matmul_batch(tiles,
                                                                    x), 9),
                plain_ms=time_ms(lambda: ref.coded_matvec_ref(
                    flat, x, out_dtype=torch.float64)),
                library_ms=time_ms(lambda: torch.matmul(flat, x), 9),
                library_queued_ms=time_queued_ms(
                    lambda: torch.matmul(flat, x)),
                library_graph_ms=time_graph_ms(
                    lambda: torch.matmul(flat, x)),
                bound_ms=bound(4.0 * (nt * TILE * K + K * C)
                               + 8.0 * nt * TILE * C,
                               [2.0 * nt * TILE * K * C
                                / F64_FLOP_PER_S])[0],
                max_abs_err=err)
            print(f"[c] coded_matvec trunk {stage} ({n} rows in {nt} tiles,"
                  f" K {K}, C {C}, route {row['route']}): max_abs_err="
                  f"{err:.3e} (tol {tol:.3e}), bit-equal to the parent's; "
                  f"P / F kernel {row['parent_ms']:.4f} / {row['ms']:.4f} "
                  f"ms, queued {row['parent_queued_ms']:.4f} / "
                  f"{row['queued_ms']:.4f}, graph {row['parent_graph_ms']:.4f}"
                  f" / {row['graph_ms']:.4f}; through ops "
                  f"{row['ops_ms']:.4f}; library {row['library_ms']:.4f}"
                  f", queued {row['library_queued_ms']:.4f}, graph "
                  f"{row['library_graph_ms']:.4f}; plain "
                  f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} ms",
                  flush=True)
            if err > tol:
                raise AssertionError(f"coded_matvec at the trunk stage "
                                     f"{stage} disagrees ({err} > {tol})")
            out[f"{stage} C={C}"] = row
        del tiles, flat
    return out


def trunk_contract_rows(dev, gen, key) -> dict:
    """The decode's known term (``parity_contract``) at trunk keys'
    frozen solves, against its plain version; row 3t: C = 32 takes the
    wide route, timed through the kernel wrapper beside the parent's
    8-column launches (``route="narrow"``) on the same inputs as P / F in
    turns P F F P, and through ``ops`` (the main path's entry)."""
    import torch
    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mds_encode import parity_contract_dev
    from repro_torch.kernels.plan import contract_launches
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
            launches = contract_launches(s, m, C)

            def parent():
                return parity_contract_dev(key, scale, kc, kj, y,
                                           route="narrow")

            def change():
                return parity_contract_dev(key, scale, kc, kj, y)
            if max_err(parent(), want) > tol:
                raise AssertionError(f"parity_contract's 8-column launches "
                                     f"at L {L}, C {C} disagree")
            row = dict(route=launches[0][1].route, launches=len(launches),
                       **pf_turns(parent, change))
            bnd = bound(4.0 * (s + m) + 8.0 * (m + s) * C,
                        parity_op_times(ents)
                        + [2.0 * ents * C / F64_FLOP_PER_S])
            row.update(
                ops_ms=time_ms(lambda: ops.parity_contract(key, L, kc, y,
                                                           cols=kj), 9),
                plain_ms=time_ms(lambda: ref.parity_contract_ref(
                    key, scale, ctrs_t, cols_t, y), 3),
                bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err)
            print(f"[c] parity_contract trunk L {L}, {s} parity rows x {m} "
                  f"known, C {C} (route {row['route']}, {len(launches)} "
                  f"launch): max_abs_err={err:.3e} (tol {tol:.3e}) P / F "
                  f"kernel {row['parent_ms']:.4f} / {row['ms']:.4f} ms, "
                  f"queued {row['parent_queued_ms']:.4f} / "
                  f"{row['queued_ms']:.4f}, graph {row['parent_graph_ms']:.4f}"
                  f" / {row['graph_ms']:.4f}; through ops {row['ops_ms']:.4f}"
                  f"; plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f}"
                  f" ms", flush=True)
            if err > tol:
                raise AssertionError(f"parity_contract at a trunk decode "
                                     f"disagrees ({err} > {tol})")
            out[f"L={L} s={s} C={C}"] = row
    return out


#: the wide contraction's gates: columns past the narrow kernel's 8, across
#: the 64-column launches and their ragged edges, at row 3t's L 2 048
#: decode (635 parity rows; gathered: the 1 413 known columns, else all
#: 2 048)
WIDE_CONTRACT_COLS = (9, 16, 32, 33, 64, 100)


def wide_contract_gates(dev, key) -> None:
    """The wide route of ``parity_contract`` (more than 8 float64
    columns) against its plain version at 1e-12 x (1 + max |want|),
    gathered and not, at WIDE_CONTRACT_COLS, one launch per 64 columns;
    each column of a C = 32 product computed alone through the wide
    route, and 45 of its rows alone, bit-equal to the whole launch's; 16
    repeated calls bit-equal."""
    import torch
    from repro_torch.core import mds
    from repro_torch.kernels import mds_encode as me
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(8)
    t0 = time.perf_counter()
    L, s = TRUNK_DECODES[0]
    scale = ops.parity_scale(L)
    ctrs = mds.parity_counters(np.arange(s), 0)
    cols = np.sort(np.random.default_rng(2).permutation(L)[:L - s])
    kc = torch.from_numpy(ctrs.view(np.int32)).to(dev)
    ctrs_t = torch.from_numpy(ctrs.astype(np.int64)).to(dev)
    worst = 0.0
    for gathered in (True, False):
        kj = torch.from_numpy(cols.astype(np.int32)).to(dev) \
            if gathered else None
        cols_t = torch.from_numpy(cols if gathered else np.arange(L)).to(dev)
        m = cols_t.numel()
        for C in WIDE_CONTRACT_COLS:
            z = torch.randn((m, C), generator=gen, device=dev,
                            dtype=torch.float64)
            n0 = me.WIDE_CONTRACT_LAUNCHES
            got = me.parity_contract_dev(key, scale, kc, kj, z)
            n_wide = me.WIDE_CONTRACT_LAUNCHES - n0
            want = ref.parity_contract_ref(key, scale, ctrs_t, cols_t, z)
            err = max_err(got, want)
            tol = 1e-12 * (1 + float(want.abs().max()))
            tag = (f"parity_contract wide {'gathered' if gathered else 'all'}"
                   f" columns, {s} x {m}, C {C}")
            if n_wide != -(-C // 64):
                raise AssertionError(f"{tag}: {n_wide} wide launches")
            if err > tol:
                raise AssertionError(f"{tag}: disagrees ({err} > {tol})")
            worst = max(worst, err / tol)
            if C == 32:
                for c in range(C):
                    alone = me.parity_contract_dev(
                        key, scale, kc, kj, z[:, c:c + 1].contiguous(),
                        route="wide")
                    if not torch.equal(alone[:, 0], got[:, c]):
                        raise AssertionError(f"{tag}: column {c} alone "
                                             f"differs")
                lo = s // 2 - 13            # off every 32-row block edge
                rows = me.parity_contract_dev(key, scale, kc[lo:lo + 45], kj,
                                              z)
                if not torch.equal(rows, got[lo:lo + 45]):
                    raise AssertionError(f"{tag}: rows {lo}..{lo + 44} "
                                         f"alone differ")
                repeat_equal(tag, got, lambda: me.parity_contract_dev(
                    key, scale, kc, kj, z))
    torch.cuda.synchronize()
    print(f"[c] parity_contract wide route: {2 * len(WIDE_CONTRACT_COLS)} "
          f"shapes agree with the plain version (largest err / tol "
          f"{worst:.3g}), one launch per 64 columns; at C = 32 every column "
          f"alone and 45 rows alone equal the whole launch's bit for bit, "
          f"16 calls bit-equal, in {time.perf_counter() - t0:.1f} s",
          flush=True)


#: the direct route's sweep: (tasks, rows, K of float32 inputs, K of
#: float64): every K past the staged slab at 2 columns, not a whole trip of
#: vectors (a K tail), one task and a stack of 3
DIRECT_SWEEP = ((1, 1237, 8196, 4098), (3, 333, 16388, 8194))


def direct_matvec_gates(dev) -> None:
    """``coded_matvec``'s direct route at 2 <= cc <= 8 columns, in all
    three type pairs, for one task and a stack, bit-equal to the parent's
    direct route (``route="element"``) and against its plain version
    (1e-12 x (1 + max |want|) for float64 sums, 2e-3 for float32); and a
    column-sliced X (float32 sums at C = 8 + cc: the launches of columns
    [0, 8) and [8, 8 + cc)) likewise."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    gen = torch.Generator(device=dev).manual_seed(9)
    t0 = time.perf_counter()
    worst, n = {}, 0
    cases = [(cc, ti, to, B, R, Kf if ti == torch.float32 else Kd, cc)
             for cc in range(2, 9)
             for ti, to in ((torch.float32, torch.float32),
                            (torch.float32, torch.float64),
                            (torch.float64, torch.float64))
             for B, R, Kf, Kd in DIRECT_SWEEP]
    cases += [(cc, torch.float32, torch.float32, 1, 1237, DIRECT_SWEEP[0][2],
               8 + cc) for cc in range(2, 9)]
    for cc, ti, to, B, R, K, C in cases:
        a = torch.randn((B, R, K), generator=gen, device=dev, dtype=ti)
        x = torch.randn((B, K, C), generator=gen, device=dev, dtype=ti)
        if B == 1:
            a, x = a[0], x[0]
        tag = (f"coded_matvec direct B {B} R {R} K {K} C {C} "
               f"{str(ti).split('.')[-1]} -> {str(to).split('.')[-1]}")
        if matvec_route(a, x, to) != "direct":
            raise AssertionError(f"{tag}: not the direct route")
        got = coded_matvec_cuda(a, x, out_dtype=to)
        old = coded_matvec_cuda(a, x, out_dtype=to, route="element")
        if not torch.equal(got, old):
            raise AssertionError(f"{tag}: not bit-equal to the parent's "
                                 f"route ({max_err(got, old)})")
        want = ref.coded_matvec_ref(a, x, out_dtype=to)
        err = max_err(got, want)
        tol = (1e-12 if to == torch.float64 else 2e-3) \
            * (1 + float(want.abs().max()))
        if err > tol:
            raise AssertionError(f"{tag}: disagrees ({err} > {tol})")
        kind = f"{str(ti).split('.')[-1]} -> {str(to).split('.')[-1]}"
        worst[kind] = max(worst.get(kind, 0.0), err / tol)
        n += 1
    torch.cuda.synchronize()
    print(f"[c] coded_matvec direct route: {n} shapes (cc 2-8, 1 and 3 "
          f"tasks, K tails, column-sliced X) bit-equal to the parent's "
          f"route and within tolerance of the plain version (largest err / "
          f"tol { {k: float(f'{v:.3g}') for k, v in worst.items()} }), in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
    sums), bit-equal to the parent's direct route (``route="element"``)
    and timed beside it as P / F in turns P F F P; and the parity kernels
    at phase n's frozen solve, s parity rows against the L - s known
    columns: ``counter_parity_rows`` at one chunk of the minor build,
    ``parity_contract`` (the decode's known term, C = 4) -- each against
    its plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mds
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
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
    print_matvec_plan("deepseek head", flat, x, torch.float64)

    def parent():
        return coded_matvec_cuda(flat, x, out_dtype=torch.float64,
                                 route="element")

    def change():
        return coded_matvec_cuda(flat, x, out_dtype=torch.float64)
    if not torch.equal(parent(), got):
        raise AssertionError("coded_matvec at the DeepSeek head: not "
                             "bit-equal to the parent's route")
    mv = dict(route=matvec_route(flat, x, torch.float64),
              **pf_turns(parent, change, 5))
    mv.update(
        ops_ms=time_ms(lambda: ops.coded_shard_matmul_batch(tiles, x)),
        ops_queued_ms=time_queued_ms(
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
          f"K {K}, C {BATCH}, float64 sums, route {mv['route']}; row 2d): "
          f"max_abs_err={err:.3e} (tol {tol:.3e}), bit-equal to the "
          f"parent's; P / F kernel {mv['parent_ms']:.4f} / {mv['ms']:.4f} "
          f"ms, queued {mv['parent_queued_ms']:.4f} / {mv['queued_ms']:.4f}"
          f", graph {mv['parent_graph_ms']:.4f} / {mv['graph_ms']:.4f}; "
          f"through ops {mv['ops_ms']:.4f} (queued "
          f"{mv['ops_queued_ms']:.4f}); plain {mv['plain_ms']:.4f}, library "
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


def matvec_route(a, x, out_dtype=None) -> str:
    """The route(s) coded_matvec runs for ``a`` @ ``x`` summed in
    ``out_dtype`` (default a's dtype)."""
    import torch
    from repro_torch.kernels.plan import matvec_launches
    B = a.shape[0] if a.dim() == 3 else 1
    out_esz = a.element_size() if out_dtype is None \
        else torch.tensor([], dtype=out_dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return "+".join(sorted({p.route for _, p in matvec_launches(
        a.element_size(), a.shape[-2], a.shape[-1], x.shape[-1], B, sms,
        out_esz)}))


def print_matvec_plan(label: str, a, x, out_dtype=None) -> None:
    """The launch plan of each column chunk coded_matvec runs for ``a``
    (R, K) or (B, R, K) against ``x`` (K, C) or (B, K, C), summed in
    ``out_dtype`` (default a's dtype)."""
    import torch
    from repro_torch.kernels.plan import matvec_launches
    B = a.shape[0] if a.dim() == 3 else 1
    R, K = a.shape[-2:]
    C = x.shape[-1]
    out_esz = a.element_size() if out_dtype is None \
        else torch.tensor([], dtype=out_dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c0, p in matvec_launches(a.element_size(), R, K, C, B, sms, out_esz):
        waves = p.blocks / (p.blocks_per_sm * sms)
        print(f"[c] plan coded_matvec {label} (columns {c0}-"
              f"{c0 + p.cc - 1}): {p.route}, grid {p.grid} x {p.splits} K "
              f"slabs of {p.k_span or K} = {p.blocks} blocks of {p.threads} "
              f"threads ({waves:.2f} waves of {p.blocks_per_sm} an SM), "
              f"{p.rows_per_block} rows a block, X slab {p.slab_bytes} B"
              f"{', X copied to [cc][K]' if p.x_copy else ''}", flush=True)


#: phase c's coded_matvec edge shapes: (B, R, K, C) -- ragged R (not a
#: multiple of any block's rows), K of 2, 6 and 10 002 (padded to the
#: 16-byte vector as ops pads it), C across the 8-column chunks
MATVEC_EDGES = ((1, 1237, 2, 1), (4, 1237, 6, 3), (1, 4099, 10002, 1),
                (4, 777, 10002, 8), (1, 3001, 6, 9), (4, 555, 2, 12),
                (1, 20011, 10002, 3), (4, 1, 6, 1))


def coded_matvec_edge_sweep(dev) -> None:
    """coded_matvec against its plain version at ragged shapes, in all
    three type pairs and all three routes: float64 outputs at 1e-12, float32
    outputs at 2e-3 (the reference's kernel tolerance), relative to 1 +
    max |want|; every call repeated bit for bit."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    gen = torch.Generator(device=dev).manual_seed(5)
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
            routes |= set(matvec_route(a, x, to).split("+"))
            n += 1
    torch.cuda.synchronize()
    if routes != {"staged", "direct", "wide"}:
        raise AssertionError(f"coded_matvec edge sweep took only {routes}")
    print(f"[c] coded_matvec edge sweep: {n} shapes x types on the "
          f"{sorted(routes)} routes "
          f"agree with the plain version (largest err / tol "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }) and repeat "
          f"bit for bit, in {time.perf_counter() - t0:.1f} s", flush=True)


#: the wide route's gates: columns (across the 8- and 64-column chunk
#: edges), contraction widths (one slab, 8 slabs of 256, 8 slabs of 1024)
#: and row counts (1 to 24 tiles of 128, the last one ragged)
WIDE_COLS = (9, 32, 64, 65)
WIDE_KS = (128, 2048, 8192)
WIDE_TILES = (1, 7, 24)


def wide_matvec_gates(dev) -> None:
    """The wide coded_matvec route (C > 8, float64 sums) against its plain
    version at 1e-12 x (1 + max |want|), float32 -> float64 and float64 ->
    float64, over WIDE_COLS x WIDE_KS x WIDE_TILES; 128 rows launched
    alone bit-equal to the same rows of the whole launch (the slabs are a
    function of K alone, so the packing layer may re-bucket rows); 16
    repeated calls bit-equal at row 2t's ``down`` shape."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    gen = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    worst, n = 0.0, 0
    for ti in (torch.float32, torch.float64):
        for C in WIDE_COLS:
            for K in WIDE_KS:
                for nt in WIDE_TILES:
                    R = nt * TILE - (37 if nt > 1 else 0)
                    a = torch.randn((R, K), generator=gen, device=dev,
                                    dtype=ti)
                    x = torch.randn((K, C), generator=gen, device=dev,
                                    dtype=ti)
                    got = coded_matvec_cuda(a, x, out_dtype=torch.float64)
                    want = ref.coded_matvec_ref(a, x,
                                                out_dtype=torch.float64)
                    err = max_err(got, want)
                    tol = 1e-12 * (1 + float(want.abs().max()))
                    tag = (f"coded_matvec wide R {R} K {K} C {C} "
                           f"{str(ti).split('.')[-1]} -> float64")
                    if matvec_route(a, x, torch.float64) != "wide":
                        raise AssertionError(f"{tag}: not the wide route")
                    if err > tol:
                        raise AssertionError(f"{tag}: disagrees ({err} > "
                                             f"{tol})")
                    worst = max(worst, err / tol)
                    if R > TILE:
                        lo = R // 2 - 45        # off every tile boundary
                        alone = coded_matvec_cuda(
                            a[lo:lo + TILE].contiguous(), x,
                            out_dtype=torch.float64)
                        if not torch.equal(alone, got[lo:lo + TILE]):
                            raise AssertionError(f"{tag}: rows {lo}.."
                                                 f"{lo + TILE - 1} launched "
                                                 f"alone differ")
                    n += 1
    a = torch.randn((2048, 8192), generator=gen, device=dev) * 0.02
    x = torch.randn((8192, 32), generator=gen, device=dev)
    repeat_equal("coded_matvec wide at the down shape",
                 coded_matvec_cuda(a, x, out_dtype=torch.float64),
                 lambda: coded_matvec_cuda(a, x, out_dtype=torch.float64))
    torch.cuda.synchronize()
    print(f"[c] coded_matvec wide route: {n} shapes agree with the plain "
          f"version (largest err / tol {worst:.3g}), 128 rows launched "
          f"alone equal the whole launch's bit for bit, 16 calls at the "
          f"down shape bit-equal, in {time.perf_counter() - t0:.1f} s",
          flush=True)


#: the stream encode's gates: (tasks, A rows, computed rows, columns,
#: per-task G): row 5g's 4 -> 2 parity rows at 2^26 + 3 columns (S ragged:
#: the 4-byte accesses) and 2^26 (16-byte vectors), per-task G over 3
#: tasks, a shared G over 2 tasks with 5 computed rows of 3, and 8 of 8
#: rows unaligned in S
STREAM_GATES = ((1, 4, 2, 2 ** 26 + 3, False), (1, 4, 2, 2 ** 26, False),
                (3, 4, 2, 1_000_003, True), (2, 3, 5, 4096, False),
                (1, 8, 8, 777, True))


def stream_encode_gates(dev) -> None:
    """The float32 stream route of ``mds_encode`` ``torch.equal`` to the
    copy_prefix + sgemm route on the same inputs, its systematic rows A
    bit for bit, at STREAM_GATES."""
    import torch
    from repro_torch.kernels.mds_encode import mds_encode_cuda
    from repro_torch.kernels.plan import encode_plan
    gen = torch.Generator(device=dev).manual_seed(7)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    for B, L, M, S, per_task in STREAM_GATES:
        a = torch.randn((B, L, S), generator=gen, device=dev)
        g = torch.randn((B, L + M, L) if per_task else (L + M, L),
                        generator=gen, device=dev)
        tag = (f"mds_encode stream B {B} ({L + M} x {L}) @ ({L} x {S})"
               f"{' per-task G' if per_task else ''}")
        if encode_plan("f32", M, S, L, B, sms).route != "stream":
            raise AssertionError(f"{tag}: not the stream route")
        got = mds_encode_cuda(g, a)
        old = mds_encode_cuda(g, a, route="gemm")
        if not (torch.equal(got, old) and torch.equal(got[:, :L], a)):
            raise AssertionError(f"{tag}: differs from the GEMM route "
                                 f"({max_err(got, old)})")
        del a, g, got, old
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[c] mds_encode stream route: {len(STREAM_GATES)} shapes equal "
          f"to the copy_prefix + sgemm route bit for bit (torch.equal), in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
    operations of the route wkv6_plan gives T at their pipe's peak
    (``plan.wkv6_ops``: the decode's 6 K V float32 operations per (b, h)
    outside the tensor cores, the chunked route's K x V products on the
    TF32 tensor cores once for each product its precision route takes --
    the count the WKV's FLOP formula credits too)."""
    from repro_torch.kernels.plan import wkv6_ops
    BH, K = B * WKV_H, WKV_K
    nbytes = (esz * 4 * BH * T * K + 4 * WKV_H * K + esz * BH * T * K
              + 4 * BH * K * K * (2 if state else 1))
    ops, pipe = wkv6_ops(T, K, K, BH, esz)
    return bound(nbytes, [ops / (F32_FLOP_PER_S if pipe == "fp32"
                                 else TF32_FLOP_PER_S)])


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


#: rows 6t / 6g: rwkv6-7b's train shape (B, T) -- phase p's microbatch of
#: 4 x 128 tokens -- and the long shape
WKV_TRAIN = (4, 128)
WKV_BWD_SHAPES = {"train": WKV_TRAIN, "long": (1, 4096)}
#: the backward at strong decays (WKV_DECAYS) against float64 autograd of
#: the sequential recurrence, at a short T
WKV_BWD_DECAY_T = 64
#: the backward's float32 operations per (bh, t) and state entry: the
#: state step, dr (S_t do_t), the D step, dk (D v), dv (Dᵀ k) and dw
#: (Σ S ⊙ D), 2 each, all at the FP32 rate: the one-block-a-row kernel's
#: bound, printed beside the two-level route's own (_wkv6_bwd_bound)
WKV_BWD_OPS = 12
WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du", "dS_0")


def _wkv6_bwd_bound(B: int, T: int, esz: int, chunk: int, H: int = None,
                    K: int = None) -> tuple:
    """Least time of one backward call on its two-level route (csrc/
    wkv6_bwd.cu).  Bytes: r, k, v, w, do read and dr, dk, dv, dw written
    in the input type, u, dS_T read and du, dS_0 written in float32 (no
    S_0: the train path starts from zeros).  Operations: ``plan.
    wkv6_bwd_ops`` (the count the FLOP formula credits too), each pipe's
    at its peak -- the TF32 tensor cores' product terms and the FMA pipe's
    direct dw walk run side by side, so each is a term of its own."""
    from repro_torch.kernels.plan import wkv6_bwd_ops
    H = WKV_H if H is None else H
    K = WKV_K if K is None else K
    BH = B * H
    nbytes = (esz * 9 * BH * T * K + 4 * 2 * H * K
              + 4 * 2 * BH * K * K)
    ops = wkv6_bwd_ops(T, K, K, BH, esz, chunk)
    return bound(nbytes, [ops["tf32"] / TF32_FLOP_PER_S,
                          ops["fp32"] / F32_FLOP_PER_S])


def _bwd_errs(got, want, esz: int) -> list:
    """(name, err, tol) of each backward output against its plain
    version: dr, dk, dv, dw in the input type at 1e-5 x (1 + max |plain|)
    for float32 (float32 sums in another order) and 2^-7 x (1 + max
    |plain|) for bf16 (both round a float32 result to bf16, at most one
    bf16 step apart at the largest entry); du and dS_0 (float32) at 1e-5 x
    (1 + max |plain|)."""
    out = []
    for i, (name, a, b) in enumerate(zip(WKV_BWD_NAMES, got, want)):
        scale = 1 + (float(b.float().abs().max()) if b.numel() else 0.0)
        rel = 2.0 ** -7 if esz == 2 and i < 4 else 1e-5
        err = max_err(a, b.reshape(a.shape)) if a.numel() else 0.0
        out.append((name, err, rel * scale))
    return out


def _check_errs(tag: str, errs) -> float:
    """Raise if any output misses its tolerance; the largest err / tol."""
    bad = [(n, e, t) for n, e, t in errs if not e <= t]
    if bad:
        raise AssertionError(f"{tag}: " + ", ".join(
            f"{n} {e:.3e} > {t:.3e}" for n, e, t in bad))
    return max(e / t for _, e, t in errs)


def _bwd_plain(B: int, H: int, r, k, v, w, u, s0, do, dS):
    """``ref.wkv6_bwd_ref`` on (BH, T, .) rows."""
    from repro_torch.kernels import ref

    def heads(t):
        return None if t is None else t.reshape(B, H, *t.shape[1:])
    return ref.wkv6_bwd_ref(*(heads(t) for t in (r, k, v, w)), u,
                            heads(s0), heads(do), heads(dS))


def wkv6_bwd_rows(dev, report) -> dict:
    """The WKV backward kernel against its plain version
    (``ref.wkv6_bwd_ref``) at rwkv6-7b's train and long shapes in bf16
    and float32 with a random output and final-state cotangent, the plain
    version itself against ``torch.autograd`` of ``ref.wkv6_chunked_ref``
    on the same tensors; at strong decays (WKV_DECAYS) against float64
    autograd of the sequential recurrence (``ref.wkv6_seq_ref``), with S_0
    and dS_T; at WKV_EDGES; 16 calls bit-equal; each shape's plan and
    times (single, queued, from a graph).  Also row 6t, the forward at the
    train shape.  Returns the numbers for the JSON line."""
    import torch
    from repro_torch.kernels import ref, wkv6 as wk
    from repro_torch.kernels.plan import wkv6_bwd_plan, wkv6_plan
    H, K = WKV_H, WKV_K
    extra = {}

    # row 6t: the forward at the train shape, bf16, no S_0
    B, T = WKV_TRAIN
    r, k, v, w, u, _ = _wkv6_inputs(dev, B, T, torch.bfloat16)
    p = wkv6_plan(T, K, K, B * H, 4)

    def fwd():
        return wk.wkv6_cuda(r, k, v, w, u)
    out, _ = fwd()
    want, _ = ref.wkv6_chunked_ref(*(t.reshape(B, H, T, K)
                                     for t in (r, k, v, w)), u)
    torch.cuda.synchronize()
    tol = 2.0 ** -7 * (1 + float(want.float().abs().max()))
    err = max_err(out, want.reshape(out.shape))
    if err > tol:
        raise AssertionError(f"wkv6 train shape: {err} > {tol}")
    bnd = _wkv6_bound(B, T, 2, False)
    nums = dict(max_abs_err=err, ms=time_ms(fwd, 20),
                queued_ms=time_queued_ms(fwd), graph_ms=time_graph_ms(fwd),
                plain_ms=time_ms(lambda: ref.wkv6_chunked_ref(
                    *(t.reshape(B, H, T, K) for t in (r, k, v, w)), u)),
                bound_ms=bnd[0], bound_by=bnd[1], route=p.route)
    print(f"[c] row 6t, wkv6 forward at the train shape B {B} H {H} T {T} "
          f"K = V {K} bf16 ({p.route}, grid {p.grid}): max_abs_err="
          f"{err:.3e} (tol {tol:.3e}); kernel {nums['ms']:.4f} ms single, "
          f"{nums['queued_ms']:.4f} queued, {nums['graph_ms']:.4f} from a "
          f"graph; plain {nums['plain_ms']:.3f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]})", flush=True)
    extra["train_bfloat16"] = nums
    del r, k, v, w, out, want

    # the backward at the train and long shapes
    bwd = {}
    for label, (B, T) in WKV_BWD_SHAPES.items():
        bp = wkv6_bwd_plan(T, K, K, B * H)
        print(f"[c] plan wkv6_bwd {label} B {B} T {T}: head padded to "
              f"{bp.kk}, columns to {bp.vv}, 2 levels, chunk {bp.chunk} "
              f"({bp.n_chunks} a row); level 1 (boundary states) grid "
              f"{bp.states_grid} of {bp.states_threads} threads, "
              f"{bp.states_smem} B shared; level 2 (every chunk) grid "
              f"{bp.grid} of {bp.threads} threads, {bp.smem_bytes} B shared, "
              f"{bp.blocks_per_sm} an SM, checkpoints every {bp.sub} steps; "
              f"scratch {bp.scratch_bytes / 2**20:.1f} MiB; {bp.launches} "
              f"launches a call", flush=True)
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, _ = _wkv6_inputs(dev, B, T, dt, seed=2)
            gen = torch.Generator(device=dev).manual_seed(3)
            do = torch.randn(v.shape, generator=gen, device=dev).to(dt)
            dS = torch.randn((B * H, K, K), generator=gen, device=dev)

            def call():
                return wk.wkv6_bwd_cuda(r, k, v, w, u, None, do, dS)
            got = call()
            plain_ms, want = time_once(lambda: _bwd_plain(
                B, H, r, k, v, w, u, None, do, dS))
            torch.cuda.synchronize()
            name = str(dt).split(".")[-1]
            tag = f"wkv6_bwd {label} B {B} H {H} T {T} K = V {K} {name}"
            errs = _bwd_errs(got, want, r.element_size())
            worst = _check_errs(tag, errs)
            # the plain version against autograd of the chunked forward
            xs = [t.detach().clone().requires_grad_()
                  for t in (r, k, v, w, u)]
            o, s = ref.wkv6_chunked_ref(*(t.reshape(B, H, *t.shape[1:])
                                          for t in xs[:4]), xs[4])
            ag = torch.autograd.grad(
                (o.float() * do.reshape(o.shape).float()).sum()
                + (s * dS.reshape(s.shape)).sum(), xs)
            del o, s, xs
            a_errs = _bwd_errs(want[:5], ag, r.element_size())
            a_worst = _check_errs(f"{tag} plain against autograd", a_errs)
            del ag
            if label == "train" and dt == torch.bfloat16:
                for i, n in enumerate(WKV_BWD_NAMES):
                    repeat_equal(f"wkv6_bwd train {n}", got[i],
                                 lambda i=i: call()[i])
            ms = time_ms(call, 10)
            q_ms = time_queued_ms(call, 10)
            g_ms = time_graph_ms(call, 10)
            bnd = _wkv6_bwd_bound(B, T, r.element_size(), bp.chunk)
            old_bnd = bound(0, [WKV_BWD_OPS * B * H * T * K * K
                                / F32_FLOP_PER_S])[0]
            scratch_ms = 2 * bp.scratch_bytes / HBM_BYTES_PER_S * 1e3
            print(f"[c] {tag}: "
                  + ", ".join(f"{n} {e:.3e} (tol {t:.3e})"
                              for n, e, t in errs)
                  + f"; largest err / tol {worst:.3g}; the plain version "
                  f"against autograd of the chunked forward: largest err / "
                  f"tol {a_worst:.3g}; kernel {ms:.4f} ms single, "
                  f"{q_ms:.4f} queued, {g_ms:.4f} from a graph; plain "
                  f"{plain_ms:.1f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), "
                  f"graph / bound {g_ms / bnd[0]:.2f} (12 K V at "
                  f"the FP32 rate: {old_bnd:.4f} ms); the boundary states' "
                  f"write and read alone {scratch_ms:.4f} ms at the HBM "
                  f"rate", flush=True)
            bwd[f"{label}_{name}"] = dict(
                max_abs_err=max(e for _, e, _ in errs[:4]), ms=ms,
                queued_ms=q_ms, graph_ms=g_ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], bound_12kv_ms=old_bnd,
                scratch_ms=scratch_ms,
                max_err_over_tol=worst)
            if label == "train" and dt == torch.bfloat16:
                e, t = max(((e, t) for _, e, t in errs[:4]),
                           key=lambda x: x[0] / x[1])
                report("wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
                       "src/repro/models/rwkv.py:23", e, t, ms, plain_ms,
                       None, bnd, queued_ms=q_ms, graph_ms=g_ms)
            del r, k, v, w, do, dS, got, want
            torch.cuda.empty_cache()

    # strong decays against float64 autograd of the sequential recurrence
    B, T = 1, WKV_BWD_DECAY_T
    for lo, hi, zero in WKV_DECAYS:
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, s0 = _wkv6_inputs(dev, B, T, dt, lo, hi, seed=4,
                                             zero_every=zero, state=True)
            gen = torch.Generator(device=dev).manual_seed(5)
            do = torch.randn(v.shape, generator=gen, device=dev).to(dt)
            dS = torch.randn(s0.shape, generator=gen, device=dev)
            got = wk.wkv6_bwd_cuda(r, k, v, w, u, s0, do, dS)
            xs = [t.detach().double().reshape(B, H, *t.shape[1:])
                  .requires_grad_() for t in (r, k, v, w)]
            xs += [u.double().requires_grad_(),
                   s0.double().reshape(B, H, K, K).requires_grad_()]
            o, s = ref.wkv6_seq_ref(*xs)
            want = torch.autograd.grad(
                (o * do.double().reshape(o.shape)).sum()
                + (s * dS.double().reshape(s.shape)).sum(), xs)
            del o, s, xs
            name = str(dt).split(".")[-1]
            tag = (f"wkv6_bwd decays w in [{lo}, {hi}]"
                   f"{f', every {zero}th step 0' if zero else ''} T {T} "
                   f"{name}")
            # the oracle's dr, dk, dv, dw in the input type, as the kernel
            want = [t.to(dt) if i < 4 else t for i, t in enumerate(want)]
            errs = _bwd_errs(got, want, r.element_size())
            worst = _check_errs(tag + " against float64 autograd", errs)
            print(f"[c] {tag}: largest err / tol {worst:.3g} against float64 "
                  f"autograd of the sequential recurrence (dw "
                  f"{errs[3][1]:.3e}, tol {errs[3][2]:.3e})", flush=True)
            del r, k, v, w, u, s0, do, dS, got, want

    # edge shapes, both types, with S_0 where the edge has one
    worst = 0.0
    for (B, He, T, Ke, V, st) in WKV_EDGES:
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, s0 = _wkv6_inputs(dev, B, T, dt, state=st,
                                             seed=T + Ke + V, H=He, K=Ke,
                                             V=V)
            gen = torch.Generator(device=dev).manual_seed(6)
            do = torch.randn(v.shape, generator=gen, device=dev).to(dt)
            dS = torch.randn((B * He, Ke, V), generator=gen, device=dev)
            got = wk.wkv6_bwd_cuda(r, k, v, w, u, s0, do, dS)
            want = _bwd_plain(B, He, r, k, v, w, u, s0, do, dS)
            torch.cuda.synchronize()
            worst = max(worst, _check_errs(
                f"wkv6_bwd edge B {B} H {He} T {T} K {Ke} V {V} S_0 {st} "
                f"{dt}", _bwd_errs(got, want, r.element_size())))
    print(f"[c] wkv6_bwd: {len(WKV_EDGES)} edge shapes x 2 types agree with "
          f"the plain version (largest err / tol {worst:.3g})", flush=True)
    head = bwd["train_bfloat16"]
    extra["backward"] = dict(
        {k: head[k] for k in ("ms", "queued_ms", "graph_ms", "plain_ms",
                              "bound_ms", "bound_by")}, shapes=bwd)
    torch.cuda.empty_cache()
    return extra


def phase_d(dev) -> dict:
    """Uncoded serving of llama3.2-1b at its published widths.  Returns
    the prefill's ms and a decode step's (phase r reads them)."""
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
    return {"prefill_ms": t_pre * 1e3, "decode_ms": t_dec * 1e3 / (G - 1),
            "shape": (B, P, G)}


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
    for k in ("coded_matvec", "parity_contract", "parity_contract_wide",
              "gen_parity_matvec"):
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
    # Quarantines re-plan the serve, and at seed 0, the first candidate, a
    # re-planned head needs more parity rows (~110k) than the card holds
    # as a float64 minor: its decode takes the refined route
    cut = dataclasses.replace(cfg, n_repeats=TRUNK_FAULT_LAYERS)
    seed = TRUNK_SEED_CANDIDATES[0]
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
    routes0, sweeps0, rel0 = (dict(packing.ROUTES), len(packing.SWEEPS),
                              len(packing.RELEASED))
    t0 = time.perf_counter()
    rep = bridge.serve(_trunk_requests(bridge, seed))
    t_fault = time.perf_counter() - t0
    grew = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    f = rep.faults
    same = rep.tokens == clean.tokens
    routes = {k: v - routes0[k] for k, v in packing.ROUTES.items()}
    sweeps = packing.SWEEPS[sweeps0:]
    released = packing.RELEASED[rel0:]
    print(f"[l] faulted: minors factored by route {routes}; refined solves "
          f"{len(sweeps)}, sweeps each (min, max) "
          f"{(min(sweeps), max(sweeps)) if sweeps else None}; cached "
          f"factors released for room {len(released)} "
          f"({sum(released) / 2**30:.2f} GiB)", flush=True)
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
    if routes["refined"] <= 0:
        raise AssertionError("phase l faulted serve: no minor took the "
                             "refined route")
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


def _long_prefill(tag: str, cfg, params, dev, T: int) -> None:
    """One prefill of 1 x T tokens, its logits finite, and the full
    forward over the same tokens: every logit finite, the last position
    within phase j's gate of the prefill's."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model_fwd, prefill
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(1, T))).to(dev)
    with torch.inference_mode():
        caches = serve.zero_caches(cfg, 1, T + 8, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, caches = prefill(params, {"tokens": toks}, caches, cfg=cfg)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        del caches
        full = model_fwd(params, {"tokens": toks}, cfg=cfg)["logits"]
        finite = bool(torch.isfinite(full).all()
                      and torch.isfinite(last).all())
        err = max_err(last[:, -1], full[:, -1])
        top = float(full[:, -1].float().abs().max())
    tol = RWKV_LOGIT_TOL * (1 + top)
    print(f"[n] {tag}: prefill 1 x {T} tokens {t_pre * 1e3:.1f} ms "
          f"({T / t_pre:.1f} tok/s); the full forward's {full.numel()} "
          f"logits finite {finite}; last position vs the prefill's "
          f"{err:.4e} (tol {tol:.4e})", flush=True)
    if not finite or err > tol:
        raise AssertionError(f"phase n {tag}: the {T}-token prefill has "
                             f"non-finite logits or misses the full "
                             f"forward ({err} > {tol})")
    del full, last


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
        if cfg.moe is not None:
            _moe_repeat_gate(cfg.name, cfg, params, dev)
        if arch in MIXER_LONG:
            _long_prefill(cfg.name, cfg, params, dev, MIXER_LONG[arch])
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


def _moe_repeat_gate(tag: str, cfg, params, dev) -> None:
    """Two same-seed full forwards of a MoE model give the same logits,
    bit for bit: the expert combine sums in a fixed order (an unordered
    ``index_add_`` on the card did not)."""
    import torch
    from repro_torch.models import model_fwd
    B, P, S = MIXER_GATE_DEFAULT
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, P + S))).to(dev)
    with torch.inference_mode():
        a = model_fwd(params, {"tokens": toks}, cfg=cfg)["logits"]
        b = model_fwd(params, {"tokens": toks}, cfg=cfg)["logits"]
    same = torch.equal(a, b)
    print(f"[n] {tag}: two full forwards of {B} x {P + S} tokens, logits "
          f"bit-equal: {same} (max |d| {max_err(a, b):.3e})", flush=True)
    if not same:
        raise AssertionError(f"phase n {tag}: the MoE forward is not "
                             f"repeatable")
    del a, b


def phase_s(dev) -> None:
    """llama3.2-1b prefilled at its published widths and depth, 1 x 32 768
    tokens (the prefill_32k length), through ``prefill``, twice (the
    first call meets a cold allocator): tok/s and peak GiB of the second,
    the ``attention`` calls of a prefill (one a layer, 16, every one a
    launch of the tensor-core kernel).  Its
    logits at the last LONG_TAIL positions (a second prefill keeping the
    layers' states: the last one through the final norm and the head) are
    gated finite and within phase j's gate of ``model_fwd``'s over the same
    tokens, and its last position against the prefill's own."""
    import torch
    from repro_torch.kernels import attention as ka
    from repro_torch.launch import serve
    from repro_torch.models import layers as ly
    from repro_torch.models import model_fwd, prefill
    from repro_torch.models.lm import _head
    fresh_card(dev, "s")
    t_phase = time.perf_counter()
    cfg, params = serve.build_model(ARCH, smoke=False, seed=0, device=dev)
    T = LONG_PREFILL
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(1, T))).to(dev)
    with torch.inference_mode():
        caches = serve.zero_caches(cfg, 1, T + 8, device=dev)
        kv_gib = sum(t.numel() * t.element_size()
                     for t in _leaves(caches)) / 2**30
        times = []
        for _ in range(2):          # the first call from a cold allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            n0, m0 = ka.LAUNCHES, ka.MMA_LAUNCHES
            t0 = time.perf_counter()
            last, caches = prefill(params, {"tokens": toks}, caches,
                                   cfg=cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            n_attn, n_mma = ka.LAUNCHES - n0, ka.MMA_LAUNCHES - m0
        t_pre = times[-1]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[s] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} "
              f"layers (not cut), {cfg.dtype}; prefill 1 x {T} tokens: "
              f"{t_pre * 1e3:.1f} ms (the first call {times[0] * 1e3:.1f}), "
              f"{T / t_pre:.1f} tok/s, peak {peak:.2f} GiB (the KV cache "
              f"{kv_gib:.2f} GiB); attention launches {n_attn}, on the "
              f"tensor cores {n_mma} (one a layer: {cfg.n_layers})",
              flush=True)
        if n_attn != cfg.n_layers or n_mma != cfg.n_layers:
            raise AssertionError(f"phase s: {n_attn} attention launches, "
                                 f"{n_mma} on the tensor cores, expected "
                                 f"{cfg.n_layers}")
        _, _, hiddens = prefill(params, {"tokens": toks}, caches, cfg=cfg,
                                collect_layers=True)
        h = ly.rms_norm(hiddens[-1][:, -LONG_TAIL:], params["final_norm"],
                        cfg.norm_eps)
        tail = _head(params, h, cfg).float()
        del hiddens, caches, h
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        full = model_fwd(params, {"tokens": toks}, cfg=cfg)["logits"]
        full = full[:, -LONG_TAIL:].float().clone()
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
    err = max_err(tail, full)
    last_err = max_err(last[:, -1].float(), full[:, -1])
    top = float(full.abs().max())
    tol = RWKV_LOGIT_TOL * (1 + top)
    finite = bool(torch.isfinite(tail).all() and torch.isfinite(full).all()
                  and torch.isfinite(last).all())
    agree = float((tail.argmax(-1) == full.argmax(-1)).float().mean())
    print(f"[s] logits at the last {LONG_TAIL} positions vs model_fwd over "
          f"the same {T} tokens ({t_full:.2f} s): max |dlogit| {err:.4e}, "
          f"last position {last_err:.4e} (tol {tol:.4e}, max |logit| "
          f"{top:.4f}), finite {finite}, argmax agreement {agree}",
          flush=True)
    if not finite or err > tol or last_err > tol:
        raise AssertionError(f"phase s: the 32k prefill's logits miss "
                             f"model_fwd's ({err}, {last_err} > {tol})")
    del params, full, tail, last
    serve._MODEL_CACHE.clear()
    fresh_card(dev, "s")
    t = time.perf_counter() - t_phase
    print(f"[s] phase s {t:.1f} s (budget {LONG_PREFILL_BUDGET:.0f} s)",
          flush=True)


def _ckpt_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


class _TimedSaves:
    """Wraps a ``TrainLoop``'s ``save``: the (step, bytes, seconds) of each
    checkpoint, and the host time each step's timing should not count."""

    def __init__(self, loop):
        self.loop, self.save, self.saves = loop, loop.save, []
        loop.save = self

    def __call__(self):
        t0 = time.perf_counter()
        self.save()
        dt = time.perf_counter() - t0
        step = self.loop.step
        self.saves.append((step, _ckpt_bytes(
            Path(self.loop.ckpt.dir) / f"step_{step:08d}"), dt))


def _timed_run(loop) -> tuple:
    """``loop.run()`` with each step's wall time (the loop logs every
    step, which reads the loss, so a step ends on the device) less the
    saves that ran before it, and each save's bytes and seconds."""
    marks, saves = [], _TimedSaves(loop)
    t0 = time.perf_counter()
    hist = loop.run(callback=lambda s, m: marks.append(
        (s, time.perf_counter(), sum(d for _, _, d in saves.saves))))
    step_ms, last, saved = {}, t0, 0.0
    for s, t, sv in marks:
        step_ms[s] = (t - last - (sv - saved)) * 1e3
        last, saved = t, sv
    return hist, step_ms, saves.saves


def phase_o(dev) -> dict:
    """llama3.2-1b trained at its published widths and depth: a straight
    run with checkpoints, a preempted run resumed from one, Adafactor, and
    the coded gradient aggregation through the ``mds_encode`` kernel.
    Returns what ``coded_grads_row`` times (the group gradient trees and
    the generator) and the straight run's median step ms (phase r)."""
    import shutil
    import tempfile
    import torch
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import init_model
    from repro_torch.optim import adafactor_init
    from repro_torch.runtime.train_loop import (TrainLoop, TrainLoopConfig,
                                                make_train_step)
    fresh_card(dev, "o")
    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(ckpt_dir).free
    stream = TokenStream(vocab=cfg.vocab, **TRAIN_STREAM)
    tokens = TRAIN_STREAM["seq_len"] * TRAIN_STREAM["global_batch"]
    try:
        # -- 1. the straight run ------------------------------------------
        loop_cfg = TrainLoopConfig(ckpt_dir=ckpt_dir, **TRAIN_LOOP)
        torch.cuda.reset_peak_memory_stats(dev)
        straight = TrainLoop(cfg, loop_cfg, stream, rng_seed=0, device=dev)
        n_par = sum(t.numel() for t in _tree.leaves(straight.params))
        print(f"[o] {cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} "
              f"layers (not cut), vocab {cfg.vocab}, {cfg.dtype}, "
              f"{n_par} parameters; stream {TRAIN_STREAM}, loop "
              f"{TRAIN_LOOP}, AdamW, remat 'full'; checkpoint dir free "
              f"{free / 2**30:.1f} GiB", flush=True)
        hist, step_ms, saves = _timed_run(straight)
        peak_adamw = torch.cuda.max_memory_allocated(dev) / 2**30
        losses = [m["loss"] for _, m in hist]
        steady = sorted(step_ms[s] for s in range(2, TRAIN_LOOP[
            "total_steps"] + 1))
        med = steady[len(steady) // 2]
        print(f"[o] straight run: loss by step "
              f"{[round(x, 4) for x in losses]}; step ms "
              f"{ {s: round(v, 1) for s, v in step_ms.items()} }, median "
              f"of steps 2-6 {med:.1f} ms, {tokens / med * 1e3:.0f} "
              f"training tokens/s; peak {peak_adamw:.2f} GiB", flush=True)
        for step, nb, dt in saves:
            print(f"[o] save step {step}: {nb / 1e9:.3f} GB in {dt:.2f} s "
                  f"({nb / dt / 1e9:.2f} GB/s)", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"phase o: the loss did not fall over "
                                 f"{len(losses)} steps: {losses}")

        # -- 2. preempted before step 6's save, resumed from step 3 -------
        last = TRAIN_LOOP["total_steps"]
        shutil.rmtree(Path(ckpt_dir) / f"step_{last:08d}")
        resumed = TrainLoop(cfg, loop_cfg, stream, rng_seed=1, device=dev)
        t0 = time.perf_counter()
        if not resumed.try_restore():
            raise AssertionError("phase o: no checkpoint to restore")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        nb = _ckpt_bytes(Path(ckpt_dir) / f"step_{resumed.step:08d}")
        print(f"[o] restore step {resumed.step}: {nb / 1e9:.3f} GB in "
              f"{t_restore:.2f} s ({nb / t_restore / 1e9:.2f} GB/s)",
              flush=True)
        if resumed.step != TRAIN_LOOP["ckpt_every"]:
            raise AssertionError(f"phase o: restored step {resumed.step}")
        r_hist, _, r_saves = _timed_run(resumed)
        for step, nb, dt in r_saves:
            print(f"[o] resumed run, save step {step}: {nb / 1e9:.3f} GB in "
                  f"{dt:.2f} s ({nb / dt / 1e9:.2f} GB/s)", flush=True)
        a = _tree.leaves((straight.params, straight.opt_state))
        b = _tree.leaves((resumed.params, resumed.opt_state))
        differ = [i for i, (x, y) in enumerate(zip(a, b))
                  if x.dtype != y.dtype or not torch.equal(x, y)]
        print(f"[o] resumed at step 3 (seed 1 before the restore), ran to "
              f"step {resumed.step}: loss by step "
              f"{[round(m['loss'], 4) for _, m in r_hist]}; {len(a)} "
              f"param and moment leaves, {len(differ)} differ from the "
              f"straight run's", flush=True)
        if differ or len(a) != len(b):
            raise AssertionError(f"phase o: the resumed run differs from "
                                 f"the straight run at leaves {differ}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del straight, resumed, a, b
    fresh_card(dev, "o")

    # -- 3. Adafactor -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_model(0, cfg, dev)
    opt = adafactor_init(params)
    step = make_train_step(cfg, optimizer="adafactor",
                           n_microbatches=TRAIN_LOOP["n_microbatches"],
                           lr_peak=TRAIN_LOOP["lr_peak"],
                           warmup=TRAIN_LOOP["warmup"],
                           total_steps=TRAIN_LOOP["total_steps"])
    ada = []
    for s in range(ADAFACTOR_STEPS):
        params, opt, m = step(params, opt, _card_batch(stream, s, dev))
        ada.append(float(m["loss"]))
    print(f"[o] Adafactor, {ADAFACTOR_STEPS} steps: loss "
          f"{[round(x, 4) for x in ada]}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (AdamW "
          f"{peak_adamw:.2f} GiB)", flush=True)
    if not np.isfinite(ada).all():
        raise AssertionError(f"phase o: Adafactor's loss {ada}")
    del params, opt, step

    state = _coded_grads(dev, cfg, stream)
    state["adamw_bytes_per_param"] = peak_adamw * 2**30 / n_par
    state["step_ms"] = med
    print(f"[o] phase o {time.perf_counter() - t_phase:.1f} s", flush=True)
    return state


def _tmix_grads(params: dict, x, ct, cfg) -> dict:
    """Gradients of sum(apply_rwkv_tmix(params, x) * ct) by parameter."""
    import torch
    from repro_torch.models import apply_rwkv_tmix
    live = {k: t.detach().requires_grad_() for k, t in params.items()}
    with torch.enable_grad():
        out, _ = apply_rwkv_tmix(live, x, cfg=cfg)
        loss = (out.float() * ct.float()).sum()
        g = torch.autograd.grad(loss, list(live.values()))
    return dict(zip(live, g))


def phase_p(dev, bytes_per_param: float) -> float:
    """rwkv6-7b trained at its published widths, 8 of its 32 repeats: the
    memory reckoning and 6 AdamW steps gated on the loss falling, every
    WKV forward and backward through the kernels (``rwkv_train_gates``
    holds its gradients to the plain WKV's after the launch counts are
    read).  Returns the median step ms (phase r)."""
    import torch
    from repro_torch import _tree, kernels
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_train_step
    fresh_card(dev, "p")
    t_phase = time.perf_counter()
    full = get_config(RWKV)
    cfg = _cut(full, RWKV_TRAIN_CUT)
    tokens = TRAIN_STREAM["seq_len"] * TRAIN_STREAM["global_batch"]
    card = torch.cuda.get_device_properties(dev).total_memory / 2**30
    hs = cfg.rwkv_head_size
    print(f"[p] {cfg.name}: d_model {cfg.d_model}, {cfg.d_model // hs} "
          f"heads of {hs}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; reduced: n_repeats {full.n_repeats} "
          f"→ {cfg.n_repeats}, the eager AdamW step's memory", flush=True)
    print(f"[p] memory reckoning at phase o's AdamW peak of "
          f"{bytes_per_param:.1f} B a parameter (bf16 params, grads, "
          f"moments, the update's float32 temporaries): "
          f"{full.param_count() / 1e9:.3f} G parameters at full depth → "
          f"{full.param_count() * bytes_per_param / 2**30:.1f} GiB; "
          f"{cfg.param_count() / 1e9:.3f} G at {cfg.n_repeats} repeats → "
          f"{cfg.param_count() * bytes_per_param / 2**30:.1f} GiB, of the "
          f"card's {card:.1f} GiB", flush=True)

    stream = TokenStream(vocab=cfg.vocab, **TRAIN_STREAM)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_model(0, cfg, dev)
    n_par = sum(t.numel() for t in _tree.leaves(params))
    opt = adamw_init(params)
    step = make_train_step(cfg, n_microbatches=TRAIN_LOOP["n_microbatches"],
                           lr_peak=RWKV_TRAIN_LR, warmup=TRAIN_LOOP["warmup"],
                           total_steps=RWKV_TRAIN_STEPS, optimizer="adamw")
    before = kernels.launch_counts()
    losses, step_ms = [], []
    for s in range(RWKV_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, _card_batch(stream, s, dev))
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    grew = _launched(before, "p", ("wkv6", "wkv6_bwd"))
    steady = sorted(step_ms[1:])
    med = steady[len(steady) // 2]
    per_step = cfg.n_repeats * TRAIN_LOOP["n_microbatches"]
    print(f"[p] straight run, {n_par} parameters, peak lr {RWKV_TRAIN_LR:g}, "
          f"warmup {TRAIN_LOOP['warmup']}, {RWKV_TRAIN_STEPS} steps of "
          f"{tokens} tokens: loss by step {[round(x, 4) for x in losses]}; "
          f"step ms {[round(x, 1) for x in step_ms]}, median of steps 2-"
          f"{RWKV_TRAIN_STEPS} {med:.1f} ms, {tokens / med * 1e3:.0f} "
          f"training tokens/s; peak {peak:.2f} GiB "
          f"({peak * 2**30 / n_par:.1f} B a parameter); WKV launches: "
          f"forward {grew['wkv6']} (expected {cfg.n_repeats} repeats x "
          f"{TRAIN_LOOP['n_microbatches']} microbatches x 2 forwards x "
          f"{RWKV_TRAIN_STEPS} steps = {2 * per_step * RWKV_TRAIN_STEPS}), "
          f"backward {grew['wkv6_bwd']} (expected "
          f"{per_step * RWKV_TRAIN_STEPS})", flush=True)
    if (grew["wkv6"], grew["wkv6_bwd"]) != (2 * per_step * RWKV_TRAIN_STEPS,
                                            per_step * RWKV_TRAIN_STEPS):
        raise AssertionError(f"phase p: WKV launches {grew}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"phase p: the loss did not fall over "
                             f"{len(losses)} steps: {losses}")
    del params, opt, step
    fresh_card(dev, "p")
    print(f"[p] phase p {time.perf_counter() - t_phase:.1f} s", flush=True)
    return med


def rwkv_train_gates(dev) -> None:
    """Phase p's gates that compare the WKV kernels with their plain
    versions, run after the main path's launch counts are read: the
    gradient gate at rwkv6-7b's width (layer 0's time-mix, B 4 x T 128,
    bf16: every parameter's gradient through the kernels against the same
    loss through autograd of the plain chunked WKV) and the remat policies
    full, dots and none bit-equal at 2 repeats."""
    import torch
    from repro_torch import _tree, kernels
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ModelCtx, init_model, init_rwkv_tmix
    from repro_torch.runtime.train_loop import value_and_grad
    fresh_card(dev, "p")
    full = get_config(RWKV)
    cfg = _cut(full, RWKV_TRAIN_CUT)
    B, T = WKV_TRAIN

    # -- the gradient gate at the model's width ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    lp = init_rwkv_tmix(gen, cfg, torch.bfloat16, dev)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    ct = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    before = kernels.launch_counts()
    got = _tmix_grads(lp, x, ct, cfg)
    torch.cuda.synchronize()
    grew = _launched(before, "p", ("wkv6", "wkv6_bwd"))

    def plain_heads(r, k, v, w, u, state=None):
        return ref.wkv6_chunked_ref(r, k, v, w, u, state)
    kernel_heads, ops.wkv6_heads = ops.wkv6_heads, plain_heads
    try:
        want = _tmix_grads(lp, x, ct, cfg)
    finally:
        ops.wkv6_heads = kernel_heads
    errs = {}
    for name in want:
        a, b = got[name].double(), want[name].double()
        errs[name] = (float((a - b).norm() / b.norm().clamp(min=1e-30)),
                      float((a - b).abs().max() / b.abs().max()
                            .clamp(min=1e-30)))
    print(f"[p] gradient gate, layer 0's time-mix B {B} x T {T} bf16, "
          f"{grew['wkv6']} forward and {grew['wkv6_bwd']} backward launch: "
          f"each parameter's gradient against autograd of the plain chunked "
          f"WKV, relative L2 (max abs over the leaf's largest): "
          + ", ".join(f"{n} {e:.2e} ({m:.2e})" for n, (e, m) in errs.items())
          + f"; tol {RWKV_GRAD_TOL}", flush=True)
    bad = {n: e for n, (e, _) in errs.items() if not e <= RWKV_GRAD_TOL}
    if bad:
        raise AssertionError(f"phase p: the kernels' gradients miss the "
                             f"plain version's: {bad}")
    del lp, x, ct, got, want

    stream = TokenStream(vocab=cfg.vocab, **TRAIN_STREAM)
    mb = TRAIN_STREAM["global_batch"] // TRAIN_LOOP["n_microbatches"]

    # -- remat: full, dots, none bit-equal at 2 repeats ---------------------
    small = _cut(full, {"n_repeats": RWKV_REMAT_REPEATS})
    params = init_model(0, small, dev)
    batch = {k: v[:mb] for k, v in _card_batch(stream, 0, dev).items()}
    res = {pol: value_and_grad(params, batch, cfg=small, ctx=ModelCtx(pol))
           for pol in ("none", "full", "dots")}
    l0, g0 = res["none"]
    same = {pol: bool(torch.equal(l, l0)) and all(
        torch.equal(a, b) for a, b in zip(_tree.leaves(g),
                                          _tree.leaves(g0)))
        for pol, (l, g) in res.items()}
    print(f"[p] remat at {RWKV_REMAT_REPEATS} repeats, {mb} x "
          f"{TRAIN_STREAM['seq_len']} tokens: loss {float(l0):.6f}; the "
          f"loss and {len(_tree.leaves(g0))} gradient leaves bit-equal to "
          f"no remat: {same}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"phase p: remat policies differ: {same}")
    del params, batch, res, l0, g0
    fresh_card(dev, "p")


def _coded_grads(dev, cfg, stream) -> dict:
    """Phase o's coded gradient aggregation: k group gradients of one
    step's batch encoded into n shards by the ``mds_encode`` kernel, the
    sum rebuilt from the arrived ones, against the plain float32 sum."""
    import torch
    from repro_torch import _tree, kernels
    from repro_torch.models import init_model
    from repro_torch.runtime import coded_grads
    from repro_torch.runtime.train_loop import value_and_grad
    fresh_card(dev, "o")
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_model(0, cfg, dev)
    batch = _card_batch(stream, 0, dev)
    rows = TRAIN_STREAM["global_batch"] // GRAD_K
    trees = [value_and_grad(params, {k: v[i * rows:(i + 1) * rows]
                                     for k, v in batch.items()}, cfg=cfg)[1]
             for i in range(GRAD_K)]
    del params
    D = sum(t.numel() for t in _tree.leaves(trees[0]))
    print(f"[o] coded gradients: {GRAD_K} groups of {rows} rows, D = {D}; "
          f"reckoned peak: X {GRAD_K * D * 4 / 1e9:.1f} GB + coded "
          f"{GRAD_N * D * 4 / 1e9:.1f} GB + the bf16 group trees "
          f"{GRAD_K * D * 2 / 1e9:.1f} GB + the float32 plain sum "
          f"{D * 4 / 1e9:.1f} GB + the aggregate {D * 4 / 1e9:.1f} GB; a "
          f"whole-matrix gather + solve would add "
          f"{2 * GRAD_K * D * 4 / 1e9:.1f} GB, so the solve runs in "
          f"{-(-D // coded_grads.CHUNK_COLS)} column chunks", flush=True)
    plain = _tree.map(lambda *g: sum(t.float() for t in g), *trees)
    before = kernels.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded, ctx = coded_grads.encode_grad_shards(trees, n_coded=GRAD_N,
                                                rng=GRAD_RNG)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    grew = _launched(before, "o", ("mds_encode",))
    errs = {}
    for int8 in (False, True):
        t0 = time.perf_counter()
        agg = coded_grads.coded_grad_aggregate(coded, ctx, GRAD_ARRIVED,
                                               compress_int8=int8)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pairs = list(zip(_tree.leaves(agg), _tree.leaves(plain)))
        errs[int8] = max(
            float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
            for x, y in pairs)
        l2 = (sum(float((x - y).double().square().sum()) for x, y in pairs)
              / sum(float(y.double().square().sum()) for _, y in pairs))
        print(f"[o] aggregate from shards {list(GRAD_ARRIVED)} of {GRAD_N}"
              f"{' (int8)' if int8 else ''}: {dt:.2f} s, max per-leaf "
              f"error {errs[int8]:.3e} of the leaf's largest plain-sum "
              f"entry, relative L2 error {l2 ** 0.5:.3e}", flush=True)
        del agg, pairs
    print(f"[o] encode {t_enc * 1e3:.1f} ms (host clock, with the flatten "
          f"into X); launches {grew}; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    if not errs[False] <= GRAD_TOL:
        raise AssertionError(f"phase o: the coded aggregate misses the "
                             f"plain sum ({errs[False]} > {GRAD_TOL})")
    del coded, plain
    torch.cuda.empty_cache()
    return {"trees": trees, "G": ctx["G"]}


def _card_batch(stream, step: int, dev) -> dict:
    """The stream's batch of ``step`` on the card (int32)."""
    import torch
    return {k: torch.from_numpy(v).to(dev)
            for k, v in stream.batch(step).items()}


def coded_grads_row(dev, state: dict) -> dict:
    """Row 5g: the ``mds_encode`` kernel (its float32 stream route) at the
    coded-gradient shape, (n x k) @ (k x D), against its plain version and
    equal to the parent's copy_prefix + sgemm route on the first 2^28
    columns, timed single and queued beside the parent's route (P / F, in
    turns P F F P), the library call of the same work and the parity rows
    alone, and the byte bound."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mds_encode import mds_encode_cuda
    from repro_torch.kernels.plan import encode_plan
    from repro_torch.runtime import coded_grads
    X = coded_grads.flatten_grads(state.pop("trees"))[0]
    G = state["G"]
    k, D = X.shape
    n = G.shape[0]
    torch.cuda.empty_cache()
    plan = encode_plan("f32", n - k, D, k, 1,
                       torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    route = plan.route
    head = X[:, :2 ** 28][None].contiguous()
    if not torch.equal(mds_encode_cuda(G, head),
                       mds_encode_cuda(G, head, route="gemm")):
        raise AssertionError("coded gradients: the stream encode differs "
                             "from the GEMM route")
    del head
    got = ops.mds_encode(G, X)
    if not torch.equal(got[:k], X):
        raise AssertionError("coded gradients: the systematic rows are not "
                             "X bit for bit")
    err, top = 0.0, 0.0
    for c0 in range(0, D, coded_grads.CHUNK_COLS):
        cols = slice(c0, c0 + coded_grads.CHUNK_COLS)
        want = ref.mds_encode_ref(G[k:], X[:, cols])
        err = max(err, max_err(got[k:, cols], want))
        top = max(top, float(want.abs().max()))
    tol = 1e-6 * (1 + top)
    del got, want
    X3 = X[None]

    def parent():
        return mds_encode_cuda(G, X3, route="gemm")
    turns = {"P": [], "F": []}
    for who in "PFFP":
        fn = parent if who == "P" else (lambda: ops.mds_encode(G, X))
        turns[who].append((time_ms(fn, 3), time_queued_ms(fn, 5)))
        torch.cuda.empty_cache()
    ms, q_ms = (min(v[i] for v in turns["F"]) for i in range(2))
    p_ms, p_q_ms = (min(v[i] for v in turns["P"]) for i in range(2))
    torch.cuda.empty_cache()
    plain_ms = time_ms(lambda: torch.cat(
        [X, ref.mds_encode_ref(G[k:], X)]), 3)
    lib_ms = time_ms(lambda: torch.cat([X, G[k:] @ X]), 3)
    par_ms = time_ms(lambda: G[k:] @ X, 3)
    torch.cuda.empty_cache()
    bnd = bound(4.0 * (k + n) * D, [2.0 * (n - k) * k * D / F32_FLOP_PER_S])
    print(f"[o] plan mds_encode float32 coded-gradient shape: {plan}",
          flush=True)
    print(f"[o] row 5g, mds_encode float32 at the coded-gradient shape "
          f"({n} x {k}) @ ({k} x {D}), route {route}: max_abs_err={err:.3e}"
          f" (tol {tol:.3e}) P / F kernel {p_ms:.3f} / {ms:.3f} ms, queued "
          f"{p_q_ms:.3f} / {q_ms:.3f} ms, plain {plain_ms:.3f} ms, library "
          f"(cat + parity matmul) {lib_ms:.3f} ms, library on the parity "
          f"rows {par_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]})",
          flush=True)
    if err > tol:
        raise AssertionError(f"mds_encode at the coded-gradient shape "
                             f"disagrees ({err} > {tol})")
    del X, X3, state["G"]
    torch.cuda.empty_cache()
    return dict(route=route, k=k, n=n, D=D, ms=ms, queued_ms=q_ms,
                parent_ms=p_ms, parent_queued_ms=p_q_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library_parity_ms=par_ms,
                bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err)


def _q_run(cfg, params, toks, dev, ctx, mesh=None) -> dict:
    """``model_fwd`` over the prompt, ``prefill`` + ``MESH_RUN``'s decode
    steps (caches replicated over ``mesh`` when given): the logits as
    full tensors and the prefill's and decodes' seconds."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, model_fwd, prefill
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.ops import is_dtensor

    def full(t):
        return t.full_tensor() if is_dtensor(t) else t
    B, P, S = MESH_RUN
    with torch.no_grad():
        fwd = full(model_fwd(params, {"tokens": toks[:, :P]}, cfg=cfg,
                             ctx=ctx)["logits"])
        caches = serve.zero_caches(cfg, B, P + S + 8, device=dev)
        if mesh is not None:
            caches = sh.replicated(caches, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = prefill(params, {"tokens": toks[:, :P]}, caches,
                             cfg=cfg, ctx=ctx)
        lg = full(lg)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        inc = [lg]
        for i in range(S):
            pos = torch.full((B,), P + i, dtype=torch.int64, device=dev)
            lg, caches = decode_step(params, toks[:, P + i:P + i + 1], pos,
                                     caches, cfg=cfg, ctx=ctx)
            inc.append(full(lg))
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0 - t_pf
    return dict(fwd=fwd, inc=torch.cat(inc, dim=1), prefill_s=t_pf,
                decode_s=t_dec)


def _q_model(arch: str, cut, why: str, dev, mesh, dtype=None) -> dict:
    """One config of phase q on this rank: the unsharded port, then the
    sharded one on the same weights (each run twice: the second is
    timed), gated."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import ModelCtx, init_model, moe
    from repro_torch.parallel import ops as pops
    from repro_torch.parallel import sharding as sh
    import dataclasses
    cfg = _uncapped(_cut(get_config(arch), cut))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    B, P, S = MESH_RUN
    params = init_model(0, cfg, dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, P + S))).to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    plain = [_q_run(cfg, params, toks, dev, ModelCtx()) for _ in range(2)]
    peak_u = torch.cuda.max_memory_allocated(dev) / 2**30
    ps = sh.shard_params(params, mesh)
    del params
    torch.cuda.reset_peak_memory_stats(dev)
    before, ep0, emb0 = (kernels.launch_counts(), dict(moe.EP_CALLS),
                         pops.EMBED_CALLS)
    ctx = ModelCtx(mesh=mesh)
    shard = [_q_run(cfg, ps, toks, dev, ctx, mesh) for _ in range(2)]
    peak_s = torch.cuda.max_memory_allocated(dev) / 2**30
    grew = {k: v - before[k] for k, v in kernels.launch_counts().items()
            if v - before[k]}
    ep = {k: v - ep0[k] for k, v in moe.EP_CALLS.items() if v - ep0[k]}
    u, sd = plain[1], shard[1]
    top = float(u["fwd"].float().abs().max())
    err_f = max_err(sd["fwd"].float(), u["fwd"].float()) / top
    err_i = max_err(sd["inc"].float(), u["inc"].float()) \
        / float(u["inc"].float().abs().max())
    bit = torch.equal(sd["fwd"], u["fwd"]) and torch.equal(sd["inc"],
                                                            u["inc"])
    same = torch.equal(shard[0]["fwd"], shard[1]["fwd"]) and \
        torch.equal(shard[0]["inc"], shard[1]["inc"])
    tok = B * P
    out = dict(arch=arch, why=why, dtype=cfg.dtype, top=top,
               bit_equal=bool(bit),
               repeat_equal=bool(same),
               rel_err_fwd=err_f, rel_err_decode=err_i,
               prefill_tok_s=(tok / u["prefill_s"], tok / sd["prefill_s"]),
               decode_ms=(1e3 * u["decode_s"] / S, 1e3 * sd["decode_s"] / S),
               peak_gib=(peak_u, peak_s), launches=grew, ep_calls=ep,
               embeds=pops.EMBED_CALLS - emb0,
               finite=bool(torch.isfinite(sd["inc"]).all()))
    del ps, plain, shard
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _q_rank(rank: int, world: int, init: str, out: str) -> None:
    """One NCCL rank of phase q (a spawned process)."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.launch.mesh import init_group, make_local_mesh
    init_group(rank, world, init, backend="nccl")
    dev = torch.device("cuda", rank)
    mesh = make_local_mesh(world)
    kernels.reset_launch_counts()
    res = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
           "torch": str(torch.__version__),
           "models": [_q_model(a, c, w, dev, mesh)
                      for a, c, w in MESH_MODELS]
           # over several cards bf16 sums run in other orders: the
           # models once more in float32, the reference test's dtype
           + ([_q_model(a, c, w, dev, mesh, "float32")
               for a, c, w in MESH_F32] if world > 1 else []),
           "launches": kernels.launch_counts()}
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def phase_q(dev) -> dict:
    """The sharded forward (``model_fwd``, ``prefill`` and decode steps on
    DTensors, the MoE's expert-parallel bodies and the WKV kernel under
    ``local_map``) in one NCCL rank per visible card, held against the
    unsharded port on the same weights.  Returns the ranks' kernel
    launches (rank 0's)."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    fresh_card(dev, "q")
    world = torch.cuda.device_count()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_q_"))
    t0 = time.perf_counter()
    try:
        mp.spawn(_q_rank, args=(world, f"file://{work / 'store'}",
                                str(work / "q.json")), nprocs=world,
                 join=True)
        res = json.loads((work / "q.json").read_text())
    finally:
        for f in work.iterdir():
            f.unlink()
        work.rmdir()
    print(f"[q] {world} NCCL rank(s), mesh {res['mesh']}, torch "
          f"{res['torch']}; {time.perf_counter() - t0:.1f} s with the "
          f"spawn", flush=True)
    B, P, S = MESH_RUN
    for m in res["models"]:
        print(f"[q] {m['arch']} {m['dtype']} ({m['why']}): batch {B}, "
              f"prompt {P}, {S} "
              f"decode steps; sharded vs unsharded: bit-equal "
              f"{m['bit_equal']}, max |dlogit| / max |logit| forward "
              f"{m['rel_err_fwd']:.3e}, prefill + decodes "
              f"{m['rel_err_decode']:.3e}; two sharded runs bit-equal "
              f"{m['repeat_equal']}; prefill tok/s (unsharded, sharded) "
              f"({m['prefill_tok_s'][0]:.1f}, {m['prefill_tok_s'][1]:.1f}), "
              f"decode ms a step ({m['decode_ms'][0]:.2f}, "
              f"{m['decode_ms'][1]:.2f}), peak GiB "
              f"({m['peak_gib'][0]:.2f}, {m['peak_gib'][1]:.2f}); sharded "
              f"launches {m['launches']}, expert-parallel bodies "
              f"{m['ep_calls']}, sharded embeddings {m['embeds']}",
              flush=True)
        moe = m["arch"].startswith("dbrx")
        if not m["finite"] or not m["repeat_equal"] or m["embeds"] <= 0:
            raise AssertionError(f"phase q {m['arch']}: {m}")
        # the sharded math is held at the reference's sharded-test
        # tolerance on one card and in float32; bf16 over several cards
        # rounds its partial sums apart and is printed
        if (world == 1 or m["dtype"] == "float32") and max(
                m["rel_err_fwd"], m["rel_err_decode"]) > MESH_TOL:
            raise AssertionError(f"phase q {m['arch']}: sharded differs "
                                 f"from unsharded: {m}")
        if moe and m["ep_calls"].get("ep_moe", 0) <= 0:
            raise AssertionError(f"phase q {m['arch']}: no expert-parallel "
                                 f"body ran: {m}")
        # one rank runs every op on whole tensors: the dense models'
        # logits keep their bits (more ranks sum in other orders)
        if world == 1 and not moe and not m["bit_equal"]:
            raise AssertionError(f"phase q {m['arch']}: sharded differs "
                                 f"from unsharded: {m}")
        if m["arch"] == RWKV and m["launches"].get("wkv6", 0) <= 0:
            raise AssertionError("phase q: the WKV kernel did not run under "
                                 "the mesh")
    return res["launches"]


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


def phase_r1_start() -> list:
    """Phase r1's cells, each ``python -m repro_torch.launch.dryrun`` on
    fake CUDA tensors in a process of its own, all started together.
    Returns (cell, process, record directory, log) each."""
    import os
    out = ROOT / "build" / "dryrun_r1"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mp in R1_CELLS:
        log = out / f"{arch}__{shape}__{'multi' if mp else 'single'}.log"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "multi" if mp else "single",
               "--device", "cuda", "--out", str(out)]
        with open(log, "w") as f:
            procs.append(((arch, shape, mp), subprocess.Popen(
                cmd, env=env, stdout=f, stderr=subprocess.STDOUT), out, log))
    return procs


def phase_r1_finish(procs: list) -> list:
    """Wait for phase r1's cells and print each record: the three terms,
    the bottleneck, a rank's peak GiB (and its caches as held and as the
    rules would shard them), the useful ratio and the wall time.  Raises
    unless every cell traced, made no allocation on the card while
    tracing and has positive finite terms."""
    from repro_torch.configs import get_config
    recs, failed = [], []
    t0 = time.perf_counter()
    for (arch, shape, mp), proc, out, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, R1_TIMEOUT
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for _, p, _, _ in procs:
                p.kill()
                p.wait()
            raise AssertionError(f"phase r1: {arch} {shape} still tracing "
                                 f"after {R1_TIMEOUT} s")
        if rc:
            print(log.read_text()[-3000:], flush=True)
            failed.append(f"{arch} {shape} exited {rc}")
            continue
        mesh = "pod2x16x16" if mp else "pod16x16"
        name = get_config(arch).name.replace("/", "_").replace(".", "_")
        rec = json.loads((out / f"{name}__{shape}__{mesh}.json").read_text())
        ma = rec["memory_analysis"]
        terms = [rec["t_compute"], rec["t_memory"], rec["t_collective"]]
        caches = ""
        if "caches_sharded_bytes" in ma:
            caches = (f", caches {ma['caches_bytes'] / 2**30:.2f} GiB "
                      f"replicated ({ma['caches_sharded_bytes'] / 2**30:.3f}"
                      f" GiB under the rules)")
        print(f"[r1] {rec['arch']} {rec['cell']} {rec['mesh']} "
              f"({rec['n_chips']} fake ranks, {rec['microbatches']} "
              f"microbatches): compute {terms[0] * 1e3:.3f} ms, memory "
              f"{terms[1] * 1e3:.3f} ms, collective {terms[2] * 1e3:.3f} ms "
              f"-> {rec['bottleneck']}-bound; a rank's peak "
              f"{ma['peak_size_in_bytes'] / 2**30:.2f} GiB{caches}; "
              f"FLOPs {rec['flops_per_device']:.4e}, HBM bytes "
              f"{rec['bytes_per_device']:.4e}, collectives "
              f"{rec['coll_breakdown']}; useful ratio "
              f"{rec['useful_ratio']:.4f}; trace {rec['trace_s']} s, wall "
              f"{rec['wall_s']} s; allocations on the card while tracing "
              f"{rec['card_allocations']} (the process's peak there "
              f"{rec['card_bytes_allocated']} B)", flush=True)
        if rec["status"] != "ok" or rec["card_allocations"] != 0 \
                or not all(np.isfinite(t) and t > 0 for t in terms):
            failed.append(f"{arch} {shape}: {rec}")
        recs.append(rec)
    if failed:
        raise AssertionError(f"phase r1: {failed}")
    return recs


def _r2_row(label: str, cfg, cell, rep, measured_ms: float, n_micro: int
            ) -> None:
    """Print one step's roofline (the analytic estimate at MeshDesc(1, 1)
    and the fake trace's) against the card's measured median."""
    from repro_torch.launch import analytic, roofline
    est = analytic.estimate(cfg, cell, analytic.MeshDesc(1, 1),
                            n_micro=n_micro).terms()
    est_ms = max(est.values()) * 1e3
    tr_ms = max(rep.t_compute, rep.t_memory) * 1e3
    mfu = roofline.model_flops(cfg, cell) / (
        measured_ms * 1e-3 * roofline.HW["peak_flops"])
    print(f"[r2] {label}: roofline (MeshDesc(1, 1), H100 constants) "
          f"estimate {est_ms:.3f} ms ({max(est, key=est.get)}), traced "
          f"{tr_ms:.3f} ms ({rep.bottleneck}: compute "
          f"{rep.t_compute * 1e3:.3f}, memory {rep.t_memory * 1e3:.3f}); "
          f"measured median {measured_ms:.3f} ms; bound / measured "
          f"{est_ms / measured_ms:.4f} (estimate), {tr_ms / measured_ms:.4f}"
          f" (traced); mfu {mfu:.5f}", flush=True)


def phase_r2(dev, measured: dict) -> None:
    """The roofline against the card's own steps at world 1: phase o's
    llama3.2-1b train step, phase d's uncoded prefill and decode step and
    phase p's rwkv6-7b step, each traced on fake CUDA tensors.  Gates on
    phase o's step: the trace's FLOPs equal ``FlopCounterMode``'s over
    the same step run for real, and the trace's peak bytes lie within
    R2_PEAK_TOL of that step's ``max_memory_allocated``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.models import init_model
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train_loop import make_train_step
    fresh_card(dev, "r")
    cfg = get_config(ARCH)
    B, T = TRAIN_STREAM["global_batch"], TRAIN_STREAM["seq_len"]
    n_mb = TRAIN_LOOP["n_microbatches"]
    cell = ShapeCell("phase o step", T, B, "train")
    rep, *_ = trace_cell(cfg, cell, None, dev, microbatches=n_mb,
                         opt_state_dtype=None)
    # the same step run for real, from the stream's first batch
    stream = TokenStream(vocab=cfg.vocab, **TRAIN_STREAM)
    params = init_model(0, cfg, dev)
    opt = adamw_init(params)
    batch = _card_batch(stream, 0, dev)
    step = make_train_step(cfg, n_microbatches=n_mb,
                           lr_peak=TRAIN_LOOP["lr_peak"],
                           warmup=TRAIN_LOOP["warmup"],
                           total_steps=TRAIN_LOOP["total_steps"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as fc:
        out = step(params, opt, batch)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated(dev)
    real_flops = fc.get_total_flops()
    del out, params, opt, step
    fresh_card(dev, "r")
    fake_peak = rep.memory_analysis["peak_size_in_bytes"]
    print(f"[r2] phase o's step traced on fake tensors: FLOPs "
          f"{rep.flops_per_device:.6e}, run for real under FlopCounterMode "
          f"{real_flops:.6e} (equal {rep.flops_per_device == real_flops}); "
          f"peak {fake_peak / 2**30:.3f} GiB traced (arguments "
          f"{rep.memory_analysis['argument_size_in_bytes'] / 2**30:.3f}), "
          f"{real_peak / 2**30:.3f} GiB max_memory_allocated, ratio "
          f"{fake_peak / real_peak:.4f}", flush=True)
    if rep.flops_per_device != real_flops:
        raise AssertionError(f"phase r2: traced FLOPs "
                             f"{rep.flops_per_device} != {real_flops}")
    if abs(fake_peak / real_peak - 1) > R2_PEAK_TOL:
        raise AssertionError(f"phase r2: traced peak {fake_peak} vs "
                             f"{real_peak}")
    _r2_row(f"{cfg.name} phase o step ({B} x {T}, {n_mb} microbatches, "
            f"AdamW, remat)", cfg, cell, rep, measured["o"], n_mb)
    Bd, P, G = measured["d"]["shape"]
    pre = ShapeCell("phase d prefill", P, Bd, "prefill")
    rep, *_ = trace_cell(cfg, pre, None, dev)
    _r2_row(f"{cfg.name} phase d prefill ({Bd} x {P})", cfg, pre, rep,
            measured["d"]["prefill_ms"], 1)
    dec = ShapeCell("phase d decode", P + G + 8, Bd, "decode")
    rep, *_ = trace_cell(cfg, dec, None, dev)
    _r2_row(f"{cfg.name} phase d decode step ({Bd} rows, cache "
            f"{P + G + 8})", cfg, dec, rep, measured["d"]["decode_ms"], 1)
    rcfg = _cut(get_config(RWKV), RWKV_TRAIN_CUT)
    rep, *_ = trace_cell(rcfg, cell, None, dev, microbatches=n_mb,
                         opt_state_dtype=None)
    _r2_row(f"{rcfg.name} phase p step ({rcfg.n_repeats} repeats, {B} x "
            f"{T}, {n_mb} microbatches)", rcfg, cell, rep, measured["p"],
            n_mb)


def phase_r3(dev) -> None:
    """The card's own constants beside the cited peaks: the median bf16
    ``torch.matmul`` rate at R3_MATMUL cubed and the bandwidth of an
    R3_COPY_BYTES device-to-device copy (read + write)."""
    import torch
    from repro_torch.launch.roofline import HW
    n = R3_MATMUL
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: torch.matmul(a, b), iters=20)
    del a, b
    src = torch.empty(R3_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    cp_ms = time_ms(lambda: dst.copy_(src), iters=20)
    del src, dst
    torch.cuda.empty_cache()
    rate = 2.0 * n ** 3 / (mm_ms * 1e-3)
    bw = 2.0 * R3_COPY_BYTES / (cp_ms * 1e-3)
    print(f"[r3] {card_line()}: bf16 matmul {n}^3 median {mm_ms:.3f} ms = "
          f"{rate / 1e12:.1f} TFLOP/s ({rate / HW['peak_flops']:.3f} of the "
          f"cited {HW['peak_flops'] / 1e12:.1f}); copy of "
          f"{R3_COPY_BYTES / 2**30:.0f} GiB median {cp_ms:.3f} ms = "
          f"{bw / 1e12:.3f} TB/s read + write ({bw / HW['hbm_bw']:.3f} of "
          f"the cited {HW['hbm_bw'] / 1e12:.2f})", flush=True)


def phase_r(dev, measured: dict) -> None:
    """The analysis tools on the card: r1's production cells traced on
    fake CUDA tensors (host processes, started first), r2 and r3 on the
    card meanwhile."""
    t0 = time.perf_counter()
    procs = phase_r1_start()
    try:
        phase_r2(dev, measured)
        phase_r3(dev)
    except BaseException:
        for _, p, _, _ in procs:
            p.kill()
            p.wait()
        raise
    phase_r1_finish(procs)
    print(f"[r] phase r {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch import _tree, kernels
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
    decode_route_rows(dev)
    measured = {"d": phase_d(dev)}
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
    phase_s(dev)
    grads = phase_o(dev)
    # row 5g's group gradients wait on the host while phase p trains
    grads["trees"] = [_tree.map(lambda t: t.cpu(), t)
                      for t in grads["trees"]]
    measured["o"] = grads["step_ms"]
    measured["p"] = phase_p(dev, grads["adamw_bytes_per_param"])
    q_launches = phase_q(dev)
    launches = {k: v + q_launches[k]
                for k, v in kernels.launch_counts().items()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
        rows[name]["launches"] = n
    rows["wkv6"]["backward"]["launches"] = launches["wkv6_bwd"]
    # phase p's gradient and remat gates and row 5g run after the counts
    # are read: their launches compare the kernels, they are not the main
    # path's
    rwkv_train_gates(dev)
    grads["trees"] = [_tree.map(lambda t: t.to(dev), t)
                      for t in grads["trees"]]
    rows["mds_encode"]["coded_grads"] = coded_grads_row(dev, grads)
    del grads
    phase_r(dev, measured)
    print(f"[i] total {time.perf_counter() - t_start:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "queued_ms", "library_queued_ms", "graph_ms",
            "library_parity_ms", "two_pass_ms", "batched", "float32",
            "verify", "coded_grads", "decode_chunk", "trunk", "deepseek_head",
            "deepseek_chunk", "launch_floor",
            "serving_prefill_bfloat16", "serving_prefill_float32",
            "decode_bfloat16", "decode_float32", "long_prefill_float32",
            "train_bfloat16", "backward", "shapes", "simt_graph_ms",
            "library_graph_ms")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys
                                   if k in rows[n]}
                                  for n in ("matmul", "coded_matvec",
                                            "mds_encode",
                                            "counter_parity_rows",
                                            "parity_contract",
                                            "parity_contract_wide",
                                            "gen_parity_matvec", "wkv6",
                                            "wkv6_bwd", "attention_mma",
                                            "attention",
                                            "attention_bwd")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
