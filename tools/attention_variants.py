#!/usr/bin/env python3
"""Time variants of the tensor-core attention forward
(``csrc/attention_mma.cu``) side by side on one card, on the same inputs:

    python3 tools/attention_variants.py [--rounds N] [--shapes A,B]
                                        [VARIANT ...]

Each variant is a patched copy of this tree's source, built with the
port's nvcc flags into ``build/attention_variants/NAME/`` and swapped in
for ``_build.library("attention_mma")`` around ``attention_cuda``:

* ``tree``: the source as it is;
* ``one_part``: P as one bf16 part (rounded to nearest), no second P V
  product (the gate's reason for two parts: ``tests/
  test_torch_attention_mma.py``);
* ``zero_lo``: the second part's products kept with a zero operand (what
  the tensor cores alone cost of it);
* ``cheap_two`` / ``cheap_one``: P = S / 1024 without the softmax, in two
  parts / one (the products' time with hardly any softmax work);
* ``s_only``: S = Q Kᵀ alone (P zero, no P V product);
* ``clock``: the tree with clock64 sums per consumer warpgroup step -- the
  waits for K / V, its products (until their wait returns) and its
  softmax -- printed per step at the first shape;
* ``nwg2`` / ``bk64``: one 64-column chunk on two consumer warpgroups and
  128-key steps / on three and 64-key steps (the plan's other tilings).

Each round times the variants from CUDA graphs in turn, the order
reversed every other round, beside ``scaled_dot_product_attention``; the
median of each is printed with its bound, and whether its output equals
the tree's bit for bit.  Shapes are ``chip_smoke.ATTN_SHAPES``' (default
the 32 768-token prefill).  Needs a CUDA card and nvcc (~1.5 min).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "attention_variants"
CSRC = ROOT / "src" / "repro_torch" / "csrc"

_LO = """        pl[i >> 1][2 * (i & 1) + h] = __byte_perm(
            __float_as_uint(a - __uint_as_float(ua & 0xffff0000u)),
            __float_as_uint(c - __uint_as_float(uc & 0xffff0000u)), 0x7632);
"""
_LO_MMA = "      mma_rs<64 * VC>(oacc, pl[kk], dv);\n"
_HI = "        ph[i >> 1][2 * (i & 1) + h] = __byte_perm(ua, uc, 0x7632);\n"
_HI_RN = """        const __nv_bfloat162 hr = __floats2bfloat162_rn(a, c);
        ph[i >> 1][2 * (i & 1) + h] = *reinterpret_cast<const uint32_t*>(&hr);
"""
_SOFT_BEGIN = "    // the online softmax in log2 units"
_SOFT_END = "    l[1] += row_tree<C::NS, 1, true>(sacc);\n"
_CHEAP = """#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = sacc[4 * i + 2 * h] * 9.765625e-4f;
        const float c = sacc[4 * i + 2 * h + 1] * 9.765625e-4f;
        const uint32_t ua = __float_as_uint(a), uc = __float_as_uint(c);
""" + _HI + _LO + "      }\n    (void)k0;\n"


def _patch(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"attention_variants: variant {name} no longer "
                         f"applies to csrc/attention_mma.cu")
    return src.replace(old, new)


def _soft(src: str, body: str, name: str) -> str:
    a, b = src.find(_SOFT_BEGIN), src.find(_SOFT_END)
    if a < 0 or b < 0:
        raise SystemExit(f"attention_variants: variant {name} no longer "
                         f"applies to csrc/attention_mma.cu")
    return src[:a] + body + src[b + len(_SOFT_END):]


def _clock(src: str) -> str:
    name = "clock"
    src = _patch(src, "namespace {\n\nusing namespace hopper;",
                 "__device__ unsigned long long g_stats[8];\n\nnamespace {"
                 "\n\nusing namespace hopper;", name)
    src = _patch(src, """  for (int j = 0; j < steps; ++j) {
    const int s = j % C::ST, sp = j > 0 ? (j - 1) % C::ST : 0;""",
                 """  unsigned long long t_data = 0, t_mma = 0, t_soft = 0;
  for (int j = 0; j < steps; ++j) {
    const long long c0 = clock64();
    const int s = j % C::ST, sp = j > 0 ? (j - 1) % C::ST : 0;""", name)
    src = _patch(src, "    float sacc[C::NS];\n    wg_fence();",
                 "    const long long c1 = clock64();\n"
                 "    float sacc[C::NS];\n    wg_fence();", name)
    src = _patch(src, """    fence_regs(oacc);
    if (j > 0) mb_arrive(&empty[sp]);""", """    fence_regs(oacc);
    const long long c3 = clock64();
    t_data += c1 - c0; t_mma += c3 - c1;
    if (j > 0) mb_arrive(&empty[sp]);""", name)
    src = _patch(src, _SOFT_END + "  }\n", _SOFT_END + """    t_soft += clock64() - c3;
  }
  if ((tid & 127) == 0) {
    atomicAdd(&g_stats[0], t_data); atomicAdd(&g_stats[1], t_mma);
    atomicAdd(&g_stats[2], t_soft);
    atomicAdd(&g_stats[3], (unsigned long long)steps);
  }
""", name)
    return _patch(src, 'extern "C" {\n', '''extern "C" {

int repro_attention_stats(unsigned long long* out) {
  const cudaError_t e = cudaMemcpyFromSymbol(out, g_stats, sizeof(g_stats));
  unsigned long long z[8] = {0};
  cudaMemcpyToSymbol(g_stats, z, sizeof(z));
  return (int)e;
}
''', name)


def variants(src: str) -> dict:
    """name -> (patched source, (consumer warpgroups, keys a step) of the
    one-chunk configuration, or None for the plan's)."""
    one = _patch(_patch(src, _LO, "", "one_part"), _LO_MMA, "", "one_part")
    one = _patch(one, _HI, _HI_RN, "one_part")
    cheap_two = _soft(src, _CHEAP, "cheap_two")
    cheap_one = _patch(_patch(cheap_two, _LO, "", "cheap_one"), _LO_MMA, "",
                       "cheap_one")
    s_only = _patch(_soft(src, "    (void)k0;\n", "s_only"), _LO_MMA, "",
                    "s_only")
    s_only = _patch(s_only, "      mma_rs<64 * VC>(oacc, ph[kk], dv);\n", "",
                    "s_only")
    nwg2 = _patch(src, "    case 9: ATTN_MMA(1, 1, 96, 3);",
                  "    case 9: ATTN_MMA(1, 1, 128, 2);", "nwg2")
    bk64 = _patch(src, "    case 9: ATTN_MMA(1, 1, 96, 3);",
                  "    case 9: ATTN_MMA(1, 1, 64, 3);", "bk64")
    return {"tree": (src, None), "one_part": (one, None),
            "zero_lo": (_patch(src, _LO, "        pl[i >> 1][2 * (i & 1) + "
                                          "h] = 0u;\n", "zero_lo"), None),
            "cheap_two": (cheap_two, None), "cheap_one": (cheap_one, None),
            "s_only": (s_only, None), "clock": (_clock(src), None),
            "nwg2": (nwg2, (2, 128)), "bk64": (bk64, (3, 64))}


def plan_with(nwg_bk):
    """attention_mma_plan with the one-chunk configuration's warpgroups and
    keys a step replaced (the plan's own formulas otherwise)."""
    from repro_torch.kernels import plan as kp
    real = kp.attention_mma_plan
    if nwg_bk is None:
        return real
    nwg, bk = nwg_bk

    def plan(D, Dv, G, esz=2):
        p = real(D, Dv, G, esz)
        if p.dc != 1:
            return p
        rows, threads = 64 * nwg, 128 * (nwg + 1)
        stage = 2 * bk * 128
        stages = min(kp.ATTN_MMA_MAX_STAGES, (kp.ATTN_MMA_SMEM_BUDGET - 1024
                                              - rows * 128) // stage)
        gt = min(G, rows)
        return dataclasses.replace(
            p, rows=rows, gt=gt, bq=rows // gt, bk=bk, stages=stages,
            threads=threads, regs=65536 // threads // 8 * 8,
            smem_bytes=1024 + rows * 128 + stages * stage)
    return plan


def build(names) -> dict:
    from repro_torch.kernels import _build
    src = (CSRC / "attention_mma.cu").read_text()
    table = variants(src)
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "attention_mma.cu").write_text(table[name][0])
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(d / "lib.so"), str(d / "attention_mma.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        warn = [ln for ln in log.splitlines() if "C75" in ln or "spill" in ln
                and not ln.strip().startswith("0 bytes")]
        if warn:
            print(f"{name}: " + "; ".join(w.strip()[:160] for w in warn[:3]),
                  flush=True)
        libs[name] = (ctypes.CDLL(str(OUT / name / "lib.so")),
                      table[name][1])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*",
                    default=["tree", "one_part", "zero_lo", "cheap_two",
                             "cheap_one", "s_only", "clock"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shapes", default="llama prefill 32k")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention as ka
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    names = list(dict.fromkeys(["tree"] + args.names))
    libs = build(names)
    dev = torch.device("cuda:0")
    real_lib, real_plan = _build.library, ka.attention_mma_plan
    for si, label in enumerate(args.shapes.split(",")):
        B, T, Hq, Hkv, D, Dv, window, scale, _ = cs.ATTN_SHAPES[label]
        sc = D ** -0.5 if scale is None else scale
        q, k, v = cs._attn_inputs(dev, B, T, Hq, Hkv, D, Dv, torch.bfloat16)

        def call():
            return ka.attention_cuda(q, k, v, None, True, window, 0, sc)

        def using(name, fn):
            lib, cfg = libs[name]
            _build.library = lambda n: lib if n == "attention_mma" \
                else real_lib(n)
            ka.attention_mma_plan = plan_with(cfg)
            try:
                return fn()
            finally:
                _build.library, ka.attention_mma_plan = real_lib, real_plan
        ref = using("tree", call)[0]
        same = {n: bool(torch.equal(using(n, call)[0], ref)) for n in names}
        times = {n: [] for n in names}
        lib_f, _ = cs._sdpa(q, k, v, window, sc)
        lib_t = []
        for r in range(args.rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                times[n].append(using(n, lambda: cs.time_graph_ms(call, 5)))
            lib_t.append(cs.time_graph_ms(lib_f, 5))
        bnd = cs._attn_bound(B, T, Hq, Hkv, D, Dv, window, 2)
        med = {n: sorted(t)[len(t) // 2] for n, t in times.items()}
        each = {n: ", ".join(f"{t:.4f}" for t in ts)
                for n, ts in times.items()}
        print(f"{label}: library {sorted(lib_t)[len(lib_t) // 2]:.4f} ms, "
              f"bound {bnd[0]:.4f} ms; " + "; ".join(
                  f"{n} {med[n]:.4f} ms ({each[n]}) bit-equal {same[n]}"
                  for n in names), flush=True)
        if si == 0 and "clock" in libs:
            buf = (ctypes.c_ulonglong * 8)()
            stats = libs["clock"][0].repro_attention_stats
            stats(buf)
            using("clock", call)
            torch.cuda.synchronize()
            stats(buf)
            steps = max(int(buf[3]), 1)
            print(f"{label}: clock64 a consumer warpgroup step ({steps} "
                  f"steps): data {buf[0] / steps:.1f}, products "
                  f"{buf[1] / steps:.1f}, softmax {buf[2] / steps:.1f} "
                  f"clocks", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
