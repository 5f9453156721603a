"""Build and load the port's CUDA kernels: ``nvcc`` → shared library →
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` under the repo
root (the hash covers the source and the flags, so an edited source is
rebuilt).  Nothing here runs at import: the first launch builds what it
needs, and :func:`build_all` builds every library at once, one ``nvcc`` per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["SOURCES", "build_all", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("matmul", "coded_matvec", "mds_encode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``,
    else ``/usr/local/cuda/bin/nvcc``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> subprocess.Popen:
    BUILD.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(BUILD / f"{name}.log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc.log, proc.tmp, proc.out, proc.name = log, tmp, out, name
    return proc


def _finish(proc: subprocess.Popen) -> None:
    rc = proc.wait()
    proc.log.close()
    if rc != 0:
        text = (BUILD / f"{proc.name}.log").read_text()
        raise RuntimeError(f"nvcc failed for csrc/{proc.name}.cu "
                           f"(exit {rc}):\n{text}")
    os.replace(proc.tmp, proc.out)


def build_all(names=SOURCES) -> Dict[str, float]:
    """Build every missing library in parallel; returns ``{name: seconds}``
    for the ones compiled now (0.0 for those already built)."""
    t0 = time.perf_counter()
    procs: List[subprocess.Popen] = [_start(n) for n in names
                                     if not _target(n).exists()]
    times = {n: 0.0 for n in names}
    for p in procs:
        _finish(p)
        times[p.name] = time.perf_counter() - t0
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            _finish(_start(name))
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
    return lib
