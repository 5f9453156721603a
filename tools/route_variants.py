#!/usr/bin/env python3
"""Time the design variants of two kernel routes side by side on one card,
on the same inputs:

    python3 tools/route_variants.py [--rounds N]

* ``coded_matvec``'s direct route, summed in float64: the parent's X read
  element by element (``route="element"``), this tree's (X's rows read
  whole or from a [cc][K] copy, as ``plan.matvec_plan`` says), the copy
  forced where the plan reads rows whole, and a copy laid out in K slices
  ([slice of 128 vectors][cc][128], from a patched copy of
  ``csrc/coded_matvec.cu``), beside ``torch.matmul``; at rows 2d and 2t
  ``down`` (C = 4 float32), float64 C = 2 to 5 and float32 C = 3 and 8;
* ``parity_contract``'s wide route at row 3t's decodes (L 2 048 and
  8 192, C = 32 and 64): the parent's 8-column launches (``route=
  "narrow"``), the tile on the FP64 tensor cores, and the tile contracted
  on the FP64 FMA pipe (a patched copy of ``csrc/mds_encode.cu``).

Every variant's result must equal this tree's bit for bit (each keeps the
sum order; the contraction's 8-column launches sum in another order and
are only timed).  Each round times the variants in turn, single calls, queued
and from a CUDA graph, the order reversed every other round; the lowest of
each kind is printed beside the bound.  The patched sources are built with
the port's nvcc flags into ``build/route_variants/``.  Needs a CUDA card
and nvcc (~1 min).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "route_variants"

#: (source, text of this tree, the variant's text)
PATCHES = (
    ("coded_matvec", """    const size_t b = i / per, r = i % per;
    XT[i] = X[(b * K + r % K) * C + c0 + r / K];""",
     """    constexpr int NV = 16 / sizeof(TI), S = 128;
    const size_t b = i / per, r = i % per;
    const int k = (int)(r / cc), c = (int)(r % cc), KV = K / NV;
    const int q = k / NV, e = k % NV, s0 = (q / S) * S;
    const int len = min(S, KV - s0);
    XT[b * per + ((size_t)s0 * cc + c * len + (q - s0)) * NV + e] =
        X[(b * K + k) * C + c0 + c];"""),
    ("coded_matvec",
     "      return __ldg(reinterpret_cast<const V*>(X) + (size_t)c * KV + q);",
     """      const int s0 = (q / 128) * 128;
      return __ldg(reinterpret_cast<const V*>(X) + (size_t)s0 * CC +
                   c * min(128, KV - s0) + (q - s0));"""),
    ("mds_encode",
     "          const double b[2] = {zb[8 * jt], zb[4 * T::ZS_LD + 8 * jt]};\n"
     "          dmma(acc[i], a, b);", """#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const double r0 = rs[(mt * 16 + g) * RS_LD + ks * 8 + kk];
            const double r1 = rs[(mt * 16 + g + 8) * RS_LD + ks * 8 + kk];
            const double* zk = zs + (ks * 8 + kk) * T::ZS_LD + 8 * jt + 2 * t;
            acc[i][0] = fma(r0, zk[0], acc[i][0]);
            acc[i][1] = fma(r0, zk[1], acc[i][1]);
            acc[i][2] = fma(r1, zk[0], acc[i][2]);
            acc[i][3] = fma(r1, zk[1], acc[i][3]);
          }"""),
)

#: the direct route's shapes: (label, rows, K, C, float64 inputs)
MATVEC = (("row 2d", 129536, 7168, 4, False),
          ("row 2t down", 2048, 8192, 4, False),
          ("float64 C 2", 20000, 10000, 2, True),
          ("float64 C 4", 20000, 10000, 4, True),
          ("ragged long K", 4099, 10002, 3, True),
          ("float64 C 3", 20000, 10002, 3, True),
          ("float64 C 5", 20000, 10002, 5, True),
          ("float32 C 8", 65536, 4096, 8, False),
          ("float32 C 3", 2048, 8192, 3, False))


def build_variants() -> dict:
    """The patched sources, built; returns ``{source: ctypes library}``."""
    from repro_torch.kernels import _build
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(_build.CSRC, OUT / "csrc")
    for name, old, new in PATCHES:
        path = OUT / "csrc" / f"{name}.cu"
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"route_variants: csrc/{name}.cu no longer "
                               f"holds the text this variant patches")
        path.write_text(text.replace(old, new))
    procs = {}
    for name in {n for n, _, _ in PATCHES}:
        with open(OUT / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                 str(OUT / f"lib{name}.so"),
                 str(OUT / "csrc" / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
    _build.build_all(("coded_matvec", "mds_encode"))
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError((OUT / f"{name}.log").read_text())
        log = (OUT / f"{name}.log").read_text().splitlines()
        spills = [ln.strip() for ln in log
                  if "spill" in ln and " 0 bytes spill" not in ln]
        print(f"variant {name}: {len(spills)} kernels spill "
              f"{spills[:2]}", flush=True)
    return {name: ctypes.CDLL(str(OUT / f"lib{name}.so")) for name in procs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.core import mds
    from repro_torch.kernels import _build
    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import mds_encode as me
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("route_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    library, launches = _build.library, cmv.matvec_launches

    def variant(fn):
        def call():
            _build.library = lambda name: libs.get(name) or library(name)
            try:
                return fn()
            finally:
                _build.library = library
        return call

    def copied(*a, **kw):
        return tuple((c0, dataclasses.replace(p, x_copy=True)
                      if p.route == "direct" else p)
                     for c0, p in launches(*a, **kw))

    def forced_copy(fn):
        def call():
            cmv.matvec_launches = copied
            try:
                return fn()
            finally:
                cmv.matvec_launches = launches
        return call

    def compare(label, fns, bnd, loose=("library",)):
        """Time ``fns`` in turns; each one not in ``loose`` must equal the
        first of them bit for bit."""
        exact = [k for k in fns if k not in loose]
        first = fns[exact[0]]()
        for k in exact[1:]:
            if not torch.equal(fns[k](), first):
                raise AssertionError(f"{label}: {k} differs")
        res = {k: [] for k in fns}
        for r in range(args.rounds):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                res[k].append((cs.time_ms(fns[k], 9),
                               cs.time_queued_ms(fns[k]),
                               cs.time_graph_ms(fns[k])))
        print(f"{label} (bound {bnd:.4f} ms), single / queued / graph ms: "
              + "; ".join(f"{k} " + " / ".join(
                  f"{min(v[i] for v in res[k]):.4f}" for i in range(3))
                  for k in res), flush=True)

    for label, R, K, C, f64 in MATVEC:
        dt = torch.float64 if f64 else torch.float32
        a = torch.randn((R, K), generator=gen, device=dev, dtype=dt)
        x = torch.randn((K, C), generator=gen, device=dev, dtype=dt)

        def run(route=None):
            return cmv.coded_matvec_cuda(a, x, out_dtype=torch.float64,
                                         route=route)
        compare(f"coded_matvec {label}, {R} x {K} @ {K} x {C} "
                f"{str(dt).split('.')[-1]} -> float64",
                {"this": run, "parent": lambda: run("element"),
                 "copy": forced_copy(run),
                 "K-sliced copy": variant(forced_copy(run)),
                 "library": lambda: torch.matmul(a, x)},
                cs.bound(a.element_size() * (R * K + K * C) + 8.0 * R * C,
                         [2.0 * R * K * C / cs.F64_FLOP_PER_S])[0])
        del a, x

    key = (0x1234ABCD, 0x9E3779B8)
    rng = np.random.default_rng(1)
    for L, s in cs.TRUNK_DECODES:
        m = L - s
        ctrs = mds.parity_counters(np.arange(s), 0)
        kc = torch.from_numpy(ctrs.view(np.int32)).to(dev)
        kj = torch.from_numpy(np.sort(rng.permutation(L)[:m]).astype(
            np.int32)).to(dev)
        scale = ops.parity_scale(L)
        for C in (32, 64):
            y = torch.randn((m, C), generator=gen, device=dev,
                            dtype=torch.float64)

            def run(route=None):
                return me.parity_contract_dev(key, scale, kc, kj, y,
                                              route=route)
            ents = s * m
            # the parent's 8-column launches sum in another order: equal to
            # the wide route within tolerance only
            compare(f"parity_contract L {L}, {s} x {m} gathered, C {C}",
                    {"tensor cores": run, "FMA pipe": variant(run),
                     "parent": lambda: run("narrow")},
                    cs.bound(4.0 * (s + m) + 8.0 * (m + s) * C,
                             cs.parity_op_times(ents)
                             + [2.0 * ents * C / cs.F64_FLOP_PER_S])[0],
                    loose=("parent",))
    return 0


if __name__ == "__main__":
    sys.exit(main())
