"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each csrc/*.cu file has a plain C interface and is compiled by nvcc on its
own into a shared library for sm_90a (no PyTorch headers, so a build takes
seconds); csrc/*.cuh headers are shared by the sources and never compiled on
their own. All sources are compiled together, one nvcc process each, into
kernels/_build/<hash of the sources, headers and flags>/ (git-ignored), so a fresh
checkout builds everything on its first CUDA call and an unchanged tree
reuses the libraries. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from lip2speech_tpu_torch/csrc at first use")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict[str, float]:
    """Compile every csrc/*.cu that is not built yet, all nvcc processes at
    once. Returns {kernel library: seconds} for what was compiled; the
    compiler's register/shared-memory report lands in <name>.log."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".{src.stem}.{os.getpid()}.so"
        log = open(out_dir / f"{src.stem}.log", "w")
        procs[src.stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    times = {}
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)
    if failed:
        logs = "\n".join((out_dir / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        path = _build_dir() / f"lib{name}.so"
        if not path.exists():
            build()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
