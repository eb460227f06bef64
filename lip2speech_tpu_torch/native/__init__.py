"""Native (C) host-side helpers of the recognition path (the port's copy of
the part of the JAX package's native/__init__.py that loads them): the
Levenshtein distance of the unit WER (editdistance.c, the reference's C
`editdistance` extension) and the CTC prefix beam search (ctc_beam.c, the
reference's C++ `ctcdecode` extension).

Each source is compiled at first use with the system C compiler (`cc -O2
-shared`, no Python headers) into native/_build/<hash of the source and
flags>/ (git-ignored), as kernels/build.py does for the CUDA kernels, and
loaded with ctypes. A build that fails raises: nothing falls back to Python
on its own. The pure-Python versions (decode/units.unit_edit_distance,
data/text.ctc_beam_search(use_native=False)) are the tests' oracles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent
BUILD_ROOT = SRC / "_build"
CC_FLAGS = ["-O2", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _build_dir(stem: str) -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    h.update((SRC / f"{stem}.c").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(stem: str) -> Path:
    """Compile native/<stem>.c unless it is built already; raises
    RuntimeError when the compiler is missing or fails."""
    out = _build_dir(stem) / f"lib{stem}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{stem}.{os.getpid()}.so")
    cmd = ["cc", *CC_FLAGS, str(SRC / f"{stem}.c"), "-o", str(tmp), "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build native/{stem}.c: no C compiler `cc` on PATH") from e
    if proc.returncode != 0:
        raise RuntimeError(f"cannot build native/{stem}.c: cc exited {proc.returncode}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _cfg_editdistance(lib):
    lib.edit_distance_i32.restype = ctypes.c_int64
    lib.edit_distance_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]


def _cfg_ctc_beam(lib):
    lib.ctc_beam_search_f32.restype = ctypes.c_int64
    lib.ctc_beam_search_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]


_CONFIGURE = {"editdistance": _cfg_editdistance, "ctc_beam": _cfg_ctc_beam}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of native/<stem>.c, built first if need be."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            _CONFIGURE[stem](lib)
            _LIBS[stem] = lib
    return lib


def _i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def edit_distance(a, b) -> int:
    """Levenshtein distance between two int sequences."""
    aa = np.ascontiguousarray(np.asarray(a, dtype=np.int32))
    bb = np.ascontiguousarray(np.asarray(b, dtype=np.int32))
    out = load("editdistance").edit_distance_i32(_i32_ptr(aa), len(aa), _i32_ptr(bb), len(bb))
    if out < 0:
        raise MemoryError("edit_distance allocation failed")
    return int(out)


def ctc_beam_search_native(log_probs: np.ndarray, beam_width: int = 25,
                           blank: int = 0) -> tuple[list[int], float]:
    """C CTC prefix beam over (T, C) log-probs -> (labels, score), the
    semantics of data/text.ctc_beam_search(use_native=False)."""
    lp = np.ascontiguousarray(np.asarray(log_probs, dtype=np.float32))
    t, c = lp.shape
    out = np.zeros(max(t, 1), np.int32)
    score = ctypes.c_double(0.0)
    n = load("ctc_beam").ctc_beam_search_f32(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, c,
        int(beam_width), int(blank), _i32_ptr(out), len(out), ctypes.byref(score))
    if n < 0:
        raise MemoryError(f"ctc_beam_search_f32 failed ({n}) at T {t}, C {c}, "
                          f"beam {beam_width}")
    return [int(x) for x in out[:n]], float(score.value)
