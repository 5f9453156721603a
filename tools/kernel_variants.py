#!/usr/bin/env python3
"""Time the port's float32 GEMM core, float64 encode, ``coded_matvec`` and
``gen_parity_matvec`` as built from several checkouts, side by side on
one card.

    python3 tools/kernel_variants.py NAME=DIR [NAME=DIR ...] [--rounds N]
        [--out FILE]

Each DIR is a checkout of this repo (``.`` for this one; another commit
unpacked with ``git archive``, or a copy with the change to be tried).
Its ``src/repro_torch/csrc`` is built with the port's nvcc flags into
``build/variants/NAME/`` (one nvcc per source, all started together) and
launched with ctypes on the launch plans of its own
``src/repro_torch/kernels/plan.py``; a checkout whose plan has no
``matvec_plan`` gets ``coded_matvec``'s older entry point, which plans in
C.  Every variant runs on the same inputs, at the shapes ``chip_smoke.py``
times in phase c, beside the same-work PyTorch call:

* ``matmul`` 256 x 128 512 @ 128 512 x 2048 float32;
* ``mds_encode`` 4 x parity (1e4 x 1e4) @ (1e4 x 1e4), float32 and
  float64, and the float64 verify shape parity (1e4 x 1e4) @ (1e4 x 50);
* ``coded_matvec`` 4 x (2e4 x 1e4) . (1e4,) float64 and 128 512 x 2048
  float32 against 4 columns with float64 sums (the serving tiles, and the
  W @ x of ``gen_parity_matvec``);
* ``gen_parity_matvec`` at phase c's shape (48 876 lanes), whole (W @ x
  through the variant's ``coded_matvec``, then the contraction), its
  contraction alone, and the last variant's contraction with W @ x
  copied to six other addresses.

Each round takes the cases in turn and the variants in a rotated order.
Prints each variant's registers and spills (ptxas), its largest
difference from the library call (or from the first variant), the
median, lowest and highest CUDA-event time over the rounds, and the SM
clock and power that ``nvidia-smi`` samples over a second of ``matmul``
and of ``gen_parity_matvec``; writes the same as JSON to ``--out``
(default ``build/variants/kernel_variants.json``).  Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "variants"
SOURCES = ("matmul", "mds_encode_gemm", "coded_matvec", "mds_encode")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
U32, F32 = ctypes.c_uint32, ctypes.c_float


class Variant:
    """One checkout's kernels, built, with its launch plans."""

    def __init__(self, name: str, checkout: Path):
        self.name, self.checkout = name, checkout.resolve()
        self.csrc = self.checkout / "src" / "repro_torch" / "csrc"
        self.dir = OUT / name
        spec = importlib.util.spec_from_file_location(
            f"_plan_{name}",
            self.checkout / "src" / "repro_torch" / "kernels" / "plan.py")
        self.plan = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = self.plan
        spec.loader.exec_module(self.plan)
        self.libs = {}

    def start(self, nvcc: str, flags) -> list:
        self.dir.mkdir(parents=True, exist_ok=True)
        procs = []
        for s in SOURCES:
            log = open(self.dir / f"{s}.log", "w")
            p = subprocess.Popen([nvcc, *flags, "-o", str(self.dir /
                                                         f"lib{s}.so"),
                                  str(self.csrc / f"{s}.cu")],
                                 stdout=log, stderr=subprocess.STDOUT)
            p.log, p.label = log, f"{self.name}/{s}"
            procs.append(p)
        return procs

    def load(self) -> None:
        for s in SOURCES:
            self.libs[s] = ctypes.CDLL(str(self.dir / f"lib{s}.so"))
        self.libs["matmul"].repro_matmul_f32.argtypes = [P, P, P, P, I, I,
                                                         I, I, I, I, P]
        self.libs["mds_encode_gemm"].repro_mds_encode.argtypes = [
            I, P, LL, P, P, I, I, I, I, I, I, I, I, P, P]
        self.libs["mds_encode"].repro_gen_parity_contract.argtypes = [
            I, U32, U32, F32, P, I, P, I, I, P, P]
        self.planned_matvec = hasattr(self.plan, "matvec_plan")
        self.libs["coded_matvec"].repro_coded_matvec.argtypes = (
            [I, P, P, P] + [I] * (10 if self.planned_matvec else 5) + [P])

    def ptxas(self) -> str:
        """Registers (most) and spill stores (sum) of each library's
        kernels, from nvcc -Xptxas -v."""
        parts = []
        for s in SOURCES:
            text = (self.dir / f"{s}.log").read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spill = sum(int(b) for b in
                        re.findall(r"(\d+) bytes spill stores", text))
            parts.append(f"{s} {max(regs, default=0)} registers, {spill} B "
                         f"spilled")
        return "; ".join(parts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path, default=OUT / "kernel_variants.json")
    args = ap.parse_args()
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import mds
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels._launch import stream_ptr
    from repro_torch.kernels.mds_encode import _as_u32

    variants = [Variant(n, Path(d)) for n, d in
                (v.split("=", 1) for v in args.variants)]
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    procs = [p for v in variants
             for p in v.start(_build.nvcc_path(), _build.NVCC_FLAGS)]
    for p in procs:
        rc = p.wait()
        p.log.close()
        if rc:
            print(Path(p.log.name).read_text(), file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {p.label}")
    for v in variants:
        v.load()
        print(f"[ptxas] {v.name}: {v.ptxas()}", flush=True)
    record = {"card": cs.card_line(), "cases": {}}
    st = stream_ptr(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: cudaError_t {err}")

    def matmul(v, a, b):
        M, K = a.shape
        N = b.shape[1]
        p = v.plan.gemm_plan("f32", M, N, K, 1, sms)
        out = torch.empty((M, N), device=dev)
        ws = torch.empty((max(p.ws_elems, 1),), device=dev)

        def call():
            check(v.libs["matmul"].repro_matmul_f32(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                M, N, K, p.config.code, p.splits, p.k_span, st), "matmul")
            return out
        return call

    outs = {}

    def shared_out(shape, dtype):
        """One output a shape for every variant (each call's result is
        checked before the next variant's call overwrites it)."""
        if (shape, dtype) not in outs:
            outs.clear()
            outs[shape, dtype] = torch.empty(shape, dtype=dtype, device=dev)
        return outs[shape, dtype]

    def encode(v, g, a):
        """The parity rows of G @ A; g (B, 2L, L) or (2L, L) shared."""
        B, L, S = a.shape
        f64 = a.dtype == torch.float64
        p = v.plan.gemm_plan("f64" if f64 else "f32", L, S, L, B, sms)
        out = shared_out((B, 2 * L, S), a.dtype)
        ws = torch.empty((max(p.ws_elems, 1),), dtype=a.dtype, device=dev)

        def call():
            check(v.libs["mds_encode_gemm"].repro_mds_encode(
                int(f64), g.data_ptr(), 2 * L * L if g.dim() == 3 else 0,
                a.data_ptr(), out.data_ptr(), B, 2 * L, L, S, 1,
                p.config.code, p.splits, p.k_span, ws.data_ptr(), st),
                "mds_encode")
            return out[:, L:]
        return call

    def matvec(v, a, x, out_dtype):
        """Y = A @ X, one launch: a (B, R, K), x (B, K, C), C <= 8."""
        types = {(torch.float32, torch.float32): 0,
                 (torch.float32, torch.float64): 1,
                 (torch.float64, torch.float64): 2}[(a.dtype, out_dtype)]
        B, R, K = a.shape
        C = x.shape[-1]
        y = torch.empty((B, R, C), dtype=out_dtype, device=dev)
        fn = v.libs["coded_matvec"].repro_coded_matvec
        if v.planned_matvec:
            p = v.plan.matvec_plan(a.element_size(), R, K, C, B, sms)
            plan_args = (p.route_code, p.grid[0], p.rows_per_block,
                         p.slab_bytes, p.blocks_per_sm)
        else:
            plan_args = ()

        def call():
            check(fn(types, a.data_ptr(), x.data_ptr(), y.data_ptr(), B, R,
                     K, C, 0, *plan_args, st), "coded_matvec")
            return y
        return call

    def gen_parity(v, key, scale, c32, w, x, contract_only, offset=None):
        """W @ x then the contraction; with ``offset``, the contraction
        alone on a copy of W @ x ``offset`` elements into a new buffer."""
        L, D = w.shape
        C = x.shape[1]
        wx_call = matvec(v, w[None], x[None], torch.float64)
        wx = wx_call()[0]
        if offset is not None:
            buf = torch.empty(offset + wx.numel(), dtype=wx.dtype,
                              device=dev)
            wx = buf[offset:].view(wx.shape).copy_(wx)
        out = torch.empty((c32.numel(), C), dtype=torch.float64, device=dev)
        fn = v.libs["mds_encode"].repro_gen_parity_contract

        def call():
            src = wx if contract_only else wx_call()[0]
            check(fn(1, key[0], key[1], scale, c32.data_ptr(), c32.numel(),
                     src.data_ptr(), L, C, out.data_ptr(), st),
                  "gen_parity_contract")
            return out
        return call

    def run(label: str, make, library=None, queued=False, clocks=False,
            iters=5, calls=None):
        """Time ``make(v)()`` for every variant, or the given ``calls``
        (and ``library``), over the rounds; record and print the
        summary."""
        calls = calls or {v.name: make(v) for v in variants}
        want = library() if library else next(iter(calls.values()))()
        errs = {}
        for k, fn in calls.items():
            got = fn()
            errs[k] = float((got.double() - want.double()).abs().max()) \
                / (1 + float(want.abs().max()))
        if library:
            calls["library"] = library
        names = list(calls)
        times = {k: [] for k in names}
        qtimes = {k: [] for k in names}
        for r in range(args.rounds):
            for k in names[r % len(names):] + names[:r % len(names)]:
                times[k].append(cs.time_ms(calls[k], iters))
                if queued:
                    qtimes[k].append(cs.time_queued_ms(calls[k]))
        print(f"[{label}]", flush=True)
        rec = {}
        for k in names:
            ts = sorted(times[k])
            rec[k] = dict(ms=ts[len(ts) // 2], lo=ts[0], hi=ts[-1],
                          rel_err=errs.get(k))
            line = (f"  {k:16s} {rec[k]['ms']:9.3f} ms (range {ts[0]:.3f}-"
                    f"{ts[-1]:.3f})")
            if queued:
                qs = sorted(qtimes[k])
                rec[k].update(queued_ms=qs[len(qs) // 2], queued_lo=qs[0],
                              queued_hi=qs[-1])
                line += (f", queued {rec[k]['queued_ms']:.3f} (range "
                         f"{qs[0]:.3f}-{qs[-1]:.3f})")
            if k in errs:
                line += f", diff/(1+max) {errs[k]:.2e}"
            if clocks:
                rec[k]["clocks"] = cs.sample_clocks(calls[k])
                line += f", {rec[k]['clocks']}"
            print(line, flush=True)
        record["cases"][label] = rec

    # -- the head's products: matmul, coded_matvec's W @ x, gen_parity ------
    key = (0x1234ABCD, 0x9E3779B8)
    scale = float(ops.parity_scale(cs.L_HEAD))
    M, K, N = 256, cs.L_HEAD, cs.D
    a = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    run(f"matmul {M} x {K} @ {K} x {N} float32", lambda v: matmul(v, a, w),
        lambda: torch.matmul(a, w), clocks=True)
    del a
    x = torch.randn((N, cs.BATCH), generator=gen, device=dev)
    run(f"coded_matvec {K} x {N} float32 against {cs.BATCH} columns, "
        f"float64 sums", lambda v: matvec(v, w[None], x[None],
                                          torch.float64),
        lambda: torch.matmul(w, x)[None], queued=True)
    c32 = _as_u32(torch.from_numpy(
        mds.parity_counters(np.arange(cs.GEN_LANES), 0).astype(np.int64)
    ).to(dev))
    run(f"gen_parity_matvec {cs.GEN_LANES} lanes x {K}, float64",
        lambda v: gen_parity(v, key, scale, c32, w, x, False), clocks=True)
    run("gen_parity_matvec contraction alone",
        lambda v: gen_parity(v, key, scale, c32, w, x, True))
    # the same W @ x at other addresses (every block reads all of it
    # through L2): the last variant's contraction
    run("gen_parity_matvec contraction alone, W @ x moved",
        None, calls={f"{v.name} +{o * 8} B": gen_parity(
            v, key, scale, c32, w, x, True, o)
            for v in variants[-1:] for o in (0, 32, 4096, 131072, 180000,
                                             524288)})
    del w, x, c32
    torch.cuda.empty_cache()

    # -- the encodes --------------------------------------------------------
    Lp, B4 = cs.L_PAPER, 4
    for dt in (torch.float32, torch.float64):
        G = torch.randn((B4, 2 * Lp, Lp), generator=gen, device=dev,
                        dtype=dt) / Lp ** 0.5
        A = torch.randn((B4, Lp, Lp), generator=gen, device=dev, dtype=dt)
        run(f"mds_encode {str(dt).split('.')[-1]} {B4} x parity ({Lp} x "
            f"{Lp}) @ ({Lp} x {Lp})", lambda v: encode(v, G, A),
            lambda: torch.matmul(G[:, Lp:], A), iters=3)
        if dt == torch.float64:
            g = G[0].contiguous()
            zt = torch.randn((1, Lp, cs.VERIFY_TASKS), generator=gen,
                             device=dev, dtype=dt)
            run(f"mds_encode float64 verify parity ({Lp} x {Lp}) @ ({Lp} x "
                f"{cs.VERIFY_TASKS})", lambda v: encode(v, g, zt),
                lambda: torch.matmul(g[Lp:], zt), queued=True)
            del g, zt
        del G, A
        torch.cuda.empty_cache()

    # -- the executor's batched coded_matvec ---------------------------------
    at = torch.randn((B4, 2 * Lp, Lp), generator=gen, device=dev,
                     dtype=torch.float64)
    xb = torch.randn((B4, Lp, 1), generator=gen, device=dev,
                     dtype=torch.float64)
    run(f"coded_matvec batched {B4} x ({2 * Lp} x {Lp}) . ({Lp},) float64",
        lambda v: matvec(v, at, xb, torch.float64),
        lambda: torch.matmul(at, xb), queued=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
