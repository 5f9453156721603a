#!/usr/bin/env python3
"""Time the port's float32 GEMM core, float64 encode, ``coded_matvec``,
counter-derived parity and WKV kernels (forward and backward) as built
from several checkouts, side by side on one card.

    python3 tools/kernel_variants.py NAME=DIR [NAME=DIR ...] [--rounds N]
        [--only parity|wkv6|wkv6_bwd] [--out FILE]

Each DIR is a checkout of this repo (``.`` for this one; another commit
unpacked with ``git archive``, or a copy with the change to be tried).
Its ``src/repro_torch/csrc`` is built with the port's nvcc flags into
``build/variants/NAME/`` (one nvcc per source, all started together) and
launched with ctypes on the launch plans of its own
``src/repro_torch/kernels/plan.py``, through the C entry points of this
tree (a checkout with other ones is timed through its own
``chip_smoke.py`` instead).  Every variant runs on the same inputs, at the shapes ``chip_smoke.py``
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
  copied to six other addresses;
* the parity cases (alone with ``--only parity``, which builds only
  ``mds_encode``): ``counter_parity_rows`` at 256 x 128 512 and at a
  decode chunk of 3 370 counters x 79 636 gathered columns (bit-equal
  across variants), the contraction over columns 0..L-1 at 48 876 lanes
  against a float64 Z, and the decode's known term R[par, known] @ y at
  48 876 x 79 636 gathered, C = 4, in one contraction launch beside the
  two-pass path it replaces (counter-row chunks of 2^28 entries, float64
  cast, torch.matmul); and
  each kernel's instructions per entry in its main loop, by opcode and by
  pipe, from ``cuobjdump -sass`` of the built library;
* with ``--only wkv6`` (which builds only ``wkv6``), the WKV rows of
  phase c at rwkv6-7b's heads: the long prefill B 1 x T 4096 in bf16 and
  float32, the serving prefill B 4 x T 32 and the decode step B 4 x T 1
  with S_0 in bf16, each also replayed from a CUDA graph (device time
  alone), and each WKV kernel's instructions by pipe.  A checkout without
  ``wkv6_plan`` (an older parent) is timed through its own
  ``chip_smoke.py`` instead;
* with ``--only wkv6_bwd`` (which builds nothing itself), the WKV
  backward at phase c's row-6g shapes (train B 4 x T 128 and long B 1 x
  T 4096, K = V = 64, bf16 and float32, a random output and final-state
  cotangent), each checkout in a process of its own through its own
  ``repro_torch.kernels.wkv6.wkv6_bwd_cuda`` (its C entry point and
  launch plan may differ from this tree's), built by its own ``_build``
  into its own ``build/kernels``: single calls, queued and replayed from
  a CUDA graph, and the largest error of dr, dk, dv, dw against the
  checkout's plain ``ref.wkv6_bwd_ref``, beside this tree's bound of the
  two-level route.

Each round takes the cases in turn and the variants in a rotated order
(the backward: each round runs every checkout once, in a rotated order).
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
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "variants"
SOURCES = ("matmul", "mds_encode_gemm", "coded_matvec", "mds_encode")
#: seed 1's step shape in phase e of chip_smoke.py: parity rows, known
#: columns; and the rows of one 2^28-entry chunk of its known block
DECODE_S, DECODE_KNOWN = 48876, 79636
DECODE_CHUNK_ROWS = (1 << 28) // DECODE_KNOWN
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
U32, F32 = ctypes.c_uint32, ctypes.c_float


class Variant:
    """One checkout's kernels, built, with its launch plans."""

    def __init__(self, name: str, checkout: Path, sources=SOURCES):
        self.name, self.checkout = name, checkout.resolve()
        self.sources = sources
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
        for s in self.sources:
            log = open(self.dir / f"{s}.log", "w")
            p = subprocess.Popen([nvcc, *flags, "-o", str(self.dir /
                                                         f"lib{s}.so"),
                                  str(self.csrc / f"{s}.cu")],
                                 stdout=log, stderr=subprocess.STDOUT)
            p.log, p.label, p.variant = log, f"{self.name}/{s}", self.name
            procs.append(p)
        return procs

    def load(self) -> None:
        for s in self.sources:
            self.libs[s] = ctypes.CDLL(str(self.dir / f"lib{s}.so"))
        if "wkv6" in self.libs:
            self.libs["wkv6"].repro_wkv6.argtypes = [I] + [P] * 8 + [I] * 14 \
                + [P]
        if "mds_encode" not in self.libs:
            return
        if "matmul" in self.libs:
            self.libs["matmul"].repro_matmul_f32.argtypes = [
                P, P, P, P, I, I, I, I, I, I, P]
            self.libs["mds_encode_gemm"].repro_mds_encode.argtypes = [
                I, P, LL, P, P, I, I, I, I, I, I, I, I, P, P]
            self.libs["coded_matvec"].repro_coded_matvec.argtypes = (
                [I, P, P, P] + [I] * 10 + [P, P])
        lib = self.libs["mds_encode"]
        lib.repro_counter_parity_rows.argtypes = [U32, U32, F32, P, I, P, I,
                                                  P, P]
        lib.repro_parity_contract.argtypes = [I, U32, U32, F32, P, I, P, I,
                                              P, I, P, P]

    def kernels(self) -> dict:
        """ptxas's registers and spill stores of each mds_encode kernel,
        by (demangled-enough) name."""
        out, name = {}, None
        for ln in (self.dir / "mds_encode.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                out.setdefault(name, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and name:
                out.setdefault(name, {})["spill_stores"] = int(m.group(1))
        return out

    def ptxas(self) -> str:
        """Registers (most) and spill stores (sum) of each library's
        kernels, from nvcc -Xptxas -v."""
        parts = []
        for s in self.sources:
            text = (self.dir / f"{s}.log").read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spill = sum(int(b) for b in
                        re.findall(r"(\d+) bytes spill stores", text))
            parts.append(f"{s} {max(regs, default=0)} registers, {spill} B "
                         f"spilled")
        return "; ".join(parts)


#: SASS opcodes by the pipe that runs them (sm_90; "alu" is the integer
#: and logic pipe at half the issue rate, which alone runs LOP3 and SHF;
#: IMAD and the float32 arithmetic share the "fma" pipe)
PIPES = {
    "alu": ("LOP3", "SHF", "LEA", "IADD3", "ISETP", "SEL", "PRMT", "MOV",
            "FSEL", "FSETP", "IMNMX", "FMNMX", "PLOP3", "SGXT", "BMSK",
            "LOP", "FLO", "POPC", "IABS"),
    "fma": ("IMAD", "FFMA", "FADD", "FMUL", "VIADD", "FMNMX3"),
    "fp64": ("DFMA", "DADD", "DMUL"),
    "tensor": ("HMMA", "DMMA"),
    "conversion": ("I2F", "I2FP", "F2F", "F2I", "F2FP", "MUFU"),
    "memory": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "SHFL",
               "ATOM", "RED"),
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def _pipe(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U"):
        return "uniform"
    for pipe, ops in PIPES.items():
        if base in ops:
            return pipe
    return "control/other"


def sass_functions(lib: Path, cuobjdump: Path) -> dict:
    """{mangled kernel name: [(address, opcode, operands)]} from
    ``cuobjdump -sass``; branch targets given as labels are resolved to
    addresses."""
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, labels, cur, pending = {}, {}, None, []
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels[m.group(1)] = lab = {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(ln)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for name in pending:
                lab[name] = addr
            pending = []
            cur.append((addr, m.group(3), m.group(4)))
    for name, insns in funcs.items():
        for i, (a, op, rest) in enumerate(insns):
            t = re.search(r"`\((\.L_x_\d+)\)", rest)
            if t and t.group(1) in labels[name]:
                insns[i] = (a, op, f" 0x{labels[name][t.group(1)]:x}")
    return funcs


def main_loop(insns) -> list:
    """The instructions of the widest backward branch's range (the main
    loop), or all of them when there is no loop."""
    best = None
    for a, op, rest in insns:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < a:
            lo = int(t.group(1), 16)
            if best is None or a - lo > best[1] - best[0]:
                best = (lo, a)
    if best is None:
        return list(insns)
    return [x for x in insns if best[0] <= x[0] <= best[1]]


def sass_per_entry(v: "Variant", cuobjdump: Path) -> dict:
    """Instructions per derived entry, by opcode and by pipe, in the main
    loop of the rows kernel and of the float64 4-column contraction
    kernels.  Entries per loop trip: the rows kernel stores each entry
    once (STG), the contraction widens each one to float64 (F2F.F64)."""
    out = {}
    regs = v.kernels()
    for name, insns in sass_functions(v.dir / "libmds_encode.so",
                                      cuobjdump).items():
        # the rows kernel, and the contraction's <double, 4, GATHER>
        m = re.search(r"counter_rows_kernel|parity_contract_kernelIdLi4ELb"
                      r"([01])E", name)
        if not m:
            continue
        label = "counter_rows_kernel" if m.group(1) is None else \
            ("parity_contract_kernel " +
             ("gather" if m.group(1) == "1" else "0..m-1"))
        loop = main_loop(insns)
        ops = [op for _, op, _ in loop]
        entries = sum(op.startswith("STG") for op in ops) \
            if "rows" in label else \
            sum(op.startswith("F2F.F64") for op in ops)
        if not entries:
            continue
        hist, pipes = {}, {}
        for op in ops:
            key = ".".join(op.split(".")[:2]) if op.startswith("IMAD") \
                else op.split(".")[0]
            hist[key] = hist.get(key, 0) + 1
            pipes[_pipe(op)] = pipes.get(_pipe(op), 0) + 1
        out[label] = dict(
            kernel=name, ptxas=regs.get(name, {}), loop_insns=len(ops),
            entries_per_trip=entries,
            per_entry=round(len(ops) / entries, 2),
            pipes={k: round(c / entries, 2) for k, c in
                   sorted(pipes.items(), key=lambda kv: -kv[1])},
            opcodes={k: round(c / entries, 2) for k, c in
                     sorted(hist.items(), key=lambda kv: -kv[1])[:16]})
    return out


def wkv6_sass(v: "Variant", cuobjdump: Path) -> dict:
    """Instructions of each WKV kernel, by pipe, from the whole function
    (its loops run a data-dependent number of chunks)."""
    out = {}
    for name, insns in sass_functions(v.dir / "libwkv6.so",
                                      cuobjdump).items():
        m = re.search(r"wkv6_(chunked|decode)_kernelI(13__nv_bfloat16|f)"
                      r"Li(\d+)", name)
        if not m:
            continue
        label = (f"{m.group(1)} {'bf16' if m.group(2) != 'f' else 'f32'} "
                 f"{m.group(3)}")
        pipes = {}
        for _, op, _ in insns:
            pipes[_pipe(op)] = pipes.get(_pipe(op), 0) + 1
        out[label] = dict(kernel=name, insns=len(insns),
                          pipes=dict(sorted(pipes.items(),
                                            key=lambda kv: -kv[1])))
    return out


def wkv6_bwd_child(checkout: Path) -> int:
    """Time one checkout's WKV backward in this process; print one
    ``RESULT`` JSON line."""
    # the checkout's own package, imported before chip_smoke (this tree's
    # inputs and timers) can put this tree's src first
    sys.path.insert(0, str(checkout.resolve() / "src"))
    import torch
    from repro_torch.kernels import ref, wkv6 as wk

    import chip_smoke as cs
    dev = torch.device("cuda:0")
    H, K = cs.WKV_H, cs.WKV_K
    out = {}
    for label, (B, T) in cs.WKV_BWD_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            r, k, v, w, u, _ = cs._wkv6_inputs(dev, B, T, dt, seed=2)
            gen = torch.Generator(device=dev).manual_seed(3)
            do = torch.randn(v.shape, generator=gen, device=dev).to(dt)
            dS = torch.randn((B * H, K, K), generator=gen, device=dev)

            def call():
                return wk.wkv6_bwd_cuda(r, k, v, w, u, None, do, dS)
            got = call()
            heads = [t.reshape(B, H, *t.shape[1:]) for t in (r, k, v, w, do)]
            want = ref.wkv6_bwd_ref(*heads[:4], u, None, heads[4],
                                    dS.reshape(B, H, K, K))
            err = max(cs.max_err(a, b.reshape(a.shape))
                      for a, b in zip(got[:4], want[:4]))
            out[f"{label} {str(dt).split('.')[-1]}"] = dict(
                err=err, ms=cs.time_ms(call, 10),
                queued_ms=cs.time_queued_ms(call, 10),
                graph_ms=cs.time_graph_ms(call, 10))
            del r, k, v, w, do, dS, got, want
            torch.cuda.empty_cache()
    print("RESULT " + json.dumps(dict(module=wk.__file__, cases=out)),
          flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", choices=("all", "parity", "wkv6", "wkv6_bwd"),
                    default="all",
                    help="parity: build mds_encode alone and run only the "
                         "parity cases; wkv6: build wkv6 alone and run only "
                         "the WKV cases; wkv6_bwd: run only the WKV "
                         "backward, each checkout through its own wrapper")
    ap.add_argument("--out", type=Path, default=OUT / "kernel_variants.json")
    ap.add_argument("--bwd-child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.bwd_child is not None:
        return wkv6_bwd_child(args.bwd_child)
    if not args.variants:
        ap.error("give at least one NAME=DIR")
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import mds
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels._launch import stream_ptr
    from repro_torch.kernels.mds_encode import _as_u32

    sources = {"parity": ("mds_encode",), "wkv6": ("wkv6",),
               "wkv6_bwd": ()}.get(args.only, SOURCES)
    variants = [Variant(n, Path(d), sources) for n, d in
                (v.split("=", 1) for v in args.variants)]
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    procs = [p for v in variants
             for p in v.start(_build.nvcc_path(), _build.NVCC_FLAGS)]
    failed = set()
    for p in procs:
        rc = p.wait()
        p.log.close()
        if rc:
            # a variant that does not build is reported and left out
            print(f"nvcc failed for {p.label}:\n"
                  f"{Path(p.log.name).read_text()[-4000:]}", flush=True)
            failed.add(p.variant)
    variants = [v for v in variants if v.name not in failed]
    if not variants:
        return 1
    record = {"card": cs.card_line(), "cases": {}, "sass": {}}
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for v in variants:
        if not v.sources:
            continue
        v.load()
        print(f"[ptxas] {v.name}: {v.ptxas()}", flush=True)
        if "wkv6" in v.sources:
            record["sass"][v.name] = wkv6_sass(v, cuobjdump)
            for label, r in record["sass"][v.name].items():
                print(f"[sass] {v.name} {label}: {r['insns']} instructions; "
                      f"by pipe {r['pipes']}", flush=True)
            continue
        record["sass"][v.name] = sass_per_entry(v, cuobjdump)
        for label, r in record["sass"][v.name].items():
            print(f"[sass] {v.name} {label}: {r['per_entry']} instructions "
                  f"an entry ({r['loop_insns']} in the loop, "
                  f"{r['entries_per_trip']} entries a trip), ptxas "
                  f"{r['ptxas']}; by pipe {r['pipes']}; by opcode "
                  f"{r['opcodes']}", flush=True)
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
        p = v.plan.matvec_plan(a.element_size(), R, K, C, B, sms)
        plan_args = (p.route_code, p.grid[0], p.rows_per_block,
                     p.slab_bytes, p.blocks_per_sm)

        def call():
            check(fn(types, a.data_ptr(), x.data_ptr(), y.data_ptr(), B, R,
                     K, C, 0, *plan_args, None, st), "coded_matvec")
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
        fn = v.libs["mds_encode"].repro_parity_contract

        def call():
            src = wx if contract_only else wx_call()[0]
            check(fn(1, key[0], key[1], scale, c32.data_ptr(), c32.numel(),
                     None, L, src.data_ptr(), C, out.data_ptr(), st),
                  "parity_contract")
            return out
        return call

    def run(label: str, make, library=None, queued=False, clocks=False,
            iters=5, calls=None, entries=None, graph=False):
        """Time ``make(v)()`` for every variant, or the given ``calls``
        (and ``library``), over the rounds (with ``graph``, also replayed
        from a CUDA graph); record and print the summary."""
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
        gtimes = {k: [] for k in names}
        for r in range(args.rounds):
            for k in names[r % len(names):] + names[:r % len(names)]:
                times[k].append(cs.time_ms(calls[k], iters))
                if queued:
                    qtimes[k].append(cs.time_queued_ms(calls[k]))
                if graph:
                    gtimes[k].append(cs.time_graph_ms(calls[k]))
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
            if graph:
                gs = sorted(gtimes[k])
                rec[k].update(graph_ms=gs[len(gs) // 2], graph_lo=gs[0],
                              graph_hi=gs[-1])
                line += (f", graph {rec[k]['graph_ms']:.4f} (range "
                         f"{gs[0]:.4f}-{gs[-1]:.4f})")
            if k in errs:
                line += f", diff/(1+max) {errs[k]:.2e}"
            if entries:
                best = rec[k].get("queued_ms", rec[k]["ms"])
                rec[k]["ps_per_entry"] = best * 1e9 / entries
                line += f", {rec[k]['ps_per_entry']:.2f} ps an entry"
            if clocks:
                rec[k]["clocks"] = cs.sample_clocks(calls[k])
                line += f", {rec[k]['clocks']}"
            print(line, flush=True)
        record["cases"][label] = rec

    def gemm_cases() -> None:
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

    def parity_cases() -> None:
        key = (0x1234ABCD, 0x9E3779B8)
        k0, k1 = key
        L = cs.L_HEAD
        scale = float(ops.parity_scale(L))
        rng = np.random.default_rng(0)

        def u32(a):
            return _as_u32(torch.from_numpy(
                np.asarray(a, dtype=np.int64)).to(dev))

        def rows(v, c32, j32):
            def call():
                n, m = c32.numel(), j32.numel()
                out = torch.empty((n, m), device=dev)
                check(v.libs["mds_encode"].repro_counter_parity_rows(
                    k0, k1, scale, c32.data_ptr(), n, j32.data_ptr(), m,
                    out.data_ptr(), st), "counter_parity_rows")
                return out
            return call

        def contract(v, c32, j32, z):
            out = torch.empty((c32.numel(), z.shape[1]),
                              dtype=torch.float64, device=dev)

            def call():
                check(v.libs["mds_encode"].repro_parity_contract(
                    1, k0, k1, scale, c32.data_ptr(), c32.numel(),
                    None if j32 is None else j32.data_ptr(), z.shape[0],
                    z.data_ptr(), z.shape[1], out.data_ptr(), st),
                    "parity_contract")
                return out
            return call

        def two_pass(v, c32, j32, z):
            """The decode's known term before the contraction kernel:
            counter-row chunks of 2^28 entries, cast, torch.matmul."""
            out = torch.empty((c32.numel(), z.shape[1]),
                              dtype=torch.float64, device=dev)

            def call():
                for i in range(0, c32.numel(), DECODE_CHUNK_ROWS):
                    c = c32[i:i + DECODE_CHUNK_ROWS]
                    out[i:i + c.numel()] = rows(v, c, j32)().to(
                        torch.float64) @ z
                return out
            return call

        def bit_equal(label):
            errs = {k: r["rel_err"] for k, r in
                    record["cases"][label].items()}
            if any(e != 0.0 for e in errs.values()):
                print(f"[{label}] NOT BIT-EQUAL across variants: {errs}",
                      flush=True)
                differ.append(label)

        lab = f"counter_parity_rows 256 x {L}"
        c256, cols = u32(mds.parity_counters(np.arange(256), 0)), \
            u32(np.arange(L))
        run(lab, lambda v: rows(v, c256, cols), queued=True,
            entries=256 * L)
        bit_equal(lab)
        gcols = u32(np.sort(rng.permutation(L)[:DECODE_KNOWN]))
        cdec = u32(mds.parity_counters(np.arange(DECODE_S), 0))
        lab = (f"counter_parity_rows decode chunk {DECODE_CHUNK_ROWS} x "
               f"{DECODE_KNOWN} gathered")
        run(lab, lambda v: rows(v, cdec[:DECODE_CHUNK_ROWS], gcols),
            queued=True, entries=DECODE_CHUNK_ROWS * DECODE_KNOWN)
        bit_equal(lab)
        z = torch.randn((L, 4), generator=gen, device=dev,
                        dtype=torch.float64)
        run(f"parity contraction {cs.GEN_LANES} lanes x {L}, C = 4, "
            f"float64", lambda v: contract(v, cdec[:cs.GEN_LANES], None, z),
            queued=True, entries=cs.GEN_LANES * L)
        y = torch.randn((DECODE_KNOWN, 4), generator=gen, device=dev,
                        dtype=torch.float64)
        run(f"known term {DECODE_S} x {DECODE_KNOWN} gathered, C = 4, "
            f"float64", None, calls={
                **{v.name: contract(v, cdec, gcols, y) for v in variants},
                "two-pass": two_pass(variants[0], cdec, gcols, y)},
            queued=True, entries=DECODE_S * DECODE_KNOWN, iters=3)

    def wkv6_cases() -> None:
        types = {torch.float32: 0, torch.bfloat16: 1}
        timed = [v for v in variants if hasattr(v.plan, "wkv6_plan")]
        for v in variants:
            if v not in timed:
                print(f"[wkv6] {v.name}: no wkv6_plan in its plan.py (an "
                      f"older entry point); time it through its own "
                      f"chip_smoke.py", flush=True)
        if not timed:
            return

        def call_of(v, r, k, vv, w, u, s0, out, s_out):
            B_H, T, K = r.shape
            V = vv.shape[-1]
            p = v.plan.wkv6_plan(T, K, V, B_H, 4)
            fn = v.libs["wkv6"].repro_wkv6
            args_ = (types[r.dtype], r.data_ptr(), k.data_ptr(),
                     vv.data_ptr(), w.data_ptr(), u.data_ptr(),
                     None if s0 is None else s0.data_ptr(), out.data_ptr(),
                     s_out.data_ptr(), B_H, cs.WKV_H, T, K, V, p.route_code,
                     p.chunk, p.sub, p.kk, p.vb, p.vec, p.grid[0],
                     p.smem_bytes, p.blocks_per_sm)

            def call():
                # the current stream: a CUDA graph captures on its own
                check(fn(*args_, stream_ptr(dev)), "wkv6")
                return out
            return call

        for label, B, T, dt in (("long prefill", 1, 4096, torch.bfloat16),
                                ("long prefill", 1, 4096, torch.float32),
                                ("serving prefill", 4, 32, torch.bfloat16),
                                ("decode", 4, 1, torch.bfloat16)):
            r, k, vv, w, u, s0 = cs._wkv6_inputs(dev, B, T, dt,
                                                 state=T == 1)
            out = torch.empty((B * cs.WKV_H, T, cs.WKV_K), dtype=dt,
                              device=dev)
            s_out = torch.empty((B * cs.WKV_H, cs.WKV_K, cs.WKV_K),
                                device=dev)
            bnd = cs._wkv6_bound(B, T, r.element_size(), T == 1)
            name = str(dt).split(".")[-1]
            run(f"wkv6 {label} B {B} T {T} {name} (bound {bnd[0]:.4f} ms, "
                f"{bnd[1]})", None, queued=True, graph=True, iters=20,
                calls={v.name: call_of(v, r, k, vv, w, u, s0, out, s_out)
                       for v in timed})

    def wkv6_bwd_cases() -> None:
        from repro_torch.kernels.plan import wkv6_bwd_plan
        runs = {v.name: [] for v in variants}
        for rnd in range(args.rounds):
            j = rnd % len(variants)
            for v in variants[j:] + variants[:j]:
                p = subprocess.run([sys.executable, __file__, "--bwd-child",
                                    str(v.checkout)], capture_output=True,
                                   text=True)
                line = next((ln for ln in p.stdout.splitlines()
                             if ln.startswith("RESULT ")), None)
                if p.returncode or line is None:
                    print(p.stdout[-3000:], p.stderr[-3000:], flush=True)
                    raise SystemExit(f"{v.name}: the timing process failed")
                res = json.loads(line[7:])
                runs[v.name].append(res["cases"])
                print(f"round {rnd} {v.name} ({res['module']}): " + "; ".join(
                    f"{case} err {x['err']:.3e} single {x['ms']:.4f} "
                    f"queued {x['queued_ms']:.4f} graph {x['graph_ms']:.4f} "
                    f"ms" for case, x in res["cases"].items()), flush=True)
        for case in runs[variants[0].name][0]:
            shape, name = case.split()
            B, T = cs.WKV_BWD_SHAPES[shape]
            bp = wkv6_bwd_plan(T, cs.WKV_K, cs.WKV_K, B * cs.WKV_H)
            bnd = cs._wkv6_bwd_bound(B, T, 2 if name == "bfloat16" else 4,
                                     bp.chunk)
            label = (f"wkv6_bwd {shape} B {B} T {T} {name} (bound "
                     f"{bnd[0]:.4f} ms, {bnd[1]})")
            print(f"[{label}]", flush=True)
            rec = {}
            for v in variants:
                rs = [r[case] for r in runs[v.name]]
                rec[v.name] = dict(err=max(r["err"] for r in rs))
                line = f"  {v.name:16s}"
                for key in ("ms", "queued_ms", "graph_ms"):
                    ts = sorted(r[key] for r in rs)
                    rec[v.name].update({key: statistics.median(ts),
                                        key + "_lo": ts[0],
                                        key + "_hi": ts[-1]})
                    line += (f" {key} {rec[v.name][key]:.4f} (range "
                             f"{ts[0]:.4f}-{ts[-1]:.4f})")
                rec[v.name]["graph_over_bound"] = (rec[v.name]["graph_ms"]
                                                   / bnd[0])
                print(f"{line}, graph / bound "
                      f"{rec[v.name]['graph_over_bound']:.2f}, err "
                      f"{rec[v.name]['err']:.3e}", flush=True)
            record["cases"][label] = rec

    differ = []
    if args.only == "wkv6":
        wkv6_cases()
    elif args.only == "wkv6_bwd":
        wkv6_bwd_cases()
    else:
        if args.only == "all":
            gemm_cases()
        parity_cases()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
