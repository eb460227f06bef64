"""Native (C) host-side helpers (the port's copy of the JAX package's
native/__init__.py): the Levenshtein distance of the unit WER
(editdistance.c, the reference's C `editdistance` extension), the CTC
prefix beam search (ctc_beam.c, the reference's C++ `ctcdecode`
extension), and the libav shims of the media tools: audio decode and probe
(media_demux.c, the reference's `ffmpeg -vn -ac 1 -ar SR` subprocess) and
the listening-copy mux (media_mux.c, its `ffmpeg -map 0:v -map 1:a`).

Each source is compiled at first use with the system C compiler (`cc -O2
-shared`, no Python headers; the media shims link the system libav) into
native/_build/<hash of the source and flags>/ (git-ignored), as
kernels/build.py does for the CUDA kernels, and loaded with ctypes. A build
that fails raises BuildError: nothing falls back to Python on its own. The
pure-Python versions (decode/units.unit_edit_distance,
data/text.ctc_beam_search(use_native=False)) are the tests' oracles; the
media tools (pipeline/media.py, cli/overlay.py) catch BuildError, and only
it, to try the ffmpeg binary next, as the JAX tools do when their shim is
missing.
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

# the libraries each source links besides libm (the JAX loader's _LINK_FLAGS)
LINK_FLAGS = {
    "media_demux": ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"],
    "media_mux": ["-lavformat", "-lavcodec", "-lavutil"],
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """A native source did not build: no compiler, or the compiler (or the
    linker, for want of libav) failed."""


def _build_dir(stem: str) -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS + LINK_FLAGS.get(stem, [])).encode())
    h.update((SRC / f"{stem}.c").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(stem: str) -> Path:
    """Compile native/<stem>.c unless it is built already; raises
    BuildError when the compiler is missing or fails."""
    out = _build_dir(stem) / f"lib{stem}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{stem}.{os.getpid()}.so")
    cmd = ["cc", *CC_FLAGS, str(SRC / f"{stem}.c"), "-o", str(tmp), "-lm",
           *LINK_FLAGS.get(stem, [])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise BuildError(f"cannot build native/{stem}.c: no C compiler `cc` on PATH") from e
    if proc.returncode != 0:
        raise BuildError(f"cannot build native/{stem}.c: cc exited {proc.returncode}\n"
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


def _cfg_media_demux(lib):
    lib.l2s_decode_audio.restype = ctypes.c_long
    lib.l2s_decode_audio.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long)]
    lib.l2s_free.restype = None
    lib.l2s_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.l2s_probe_audio.restype = ctypes.c_long
    lib.l2s_probe_audio.argtypes = [ctypes.c_char_p]


def _cfg_media_mux(lib):
    lib.l2s_mux_overlay.restype = ctypes.c_long
    lib.l2s_mux_overlay.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_int, ctypes.c_char_p]


_CONFIGURE = {"editdistance": _cfg_editdistance, "ctc_beam": _cfg_ctc_beam,
              "media_demux": _cfg_media_demux, "media_mux": _cfg_media_mux}


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


_DEMUX_ERRORS = {
    -1: "container open/probe failed",
    -2: "no audio stream",
    -3: "audio decoder unavailable",
    -4: "resampler init failed",
    -5: "decode error",
    -6: "allocation failure",
}


def decode_audio(path, target_sr: int = 16000) -> np.ndarray:
    """The first audio stream of any libav container -> mono float32 at
    target_sr (the reference's `ffmpeg -i src -vn -ac 1 -ar SR` subprocess,
    config.py EXTRACT_AUDIO_COMMAND, without the binary). Raises BuildError
    when the shim does not build, ValueError on a real decode error (no
    audio stream, a corrupt file)."""
    lib = load("media_demux")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long(0)
    rc = lib.l2s_decode_audio(str(path).encode(), int(target_sr),
                              ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"audio decode of {path} failed: "
                         f"{_DEMUX_ERRORS.get(rc, f'code {rc}')}")
    try:
        if n.value == 0:
            return np.zeros(0, np.float32)
        return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.l2s_free(out)


def probe_audio_sample_rate(path) -> int:
    """The sample rate of the container's first audio stream; 0 when it has
    no audio stream. Raises BuildError when the shim does not build,
    ValueError when the container cannot be probed."""
    rc = load("media_demux").l2s_probe_audio(str(path).encode())
    if rc == -2:
        return 0
    if rc < 0:
        raise ValueError(f"cannot probe {path}")
    return int(rc)


_MUX_ERRORS = {
    -1: "cannot open input video",
    -2: "no video stream",
    -3: "cannot open output",
    -4: "AAC encoder unavailable",
    -5: "container header/trailer write failed",
    -6: "packet write failed",
    -7: "allocation failure",
}


def mux_overlay(video_path, audio: np.ndarray, sr: int, out_path) -> bool:
    """Replace a video's audio with the given mono float32 PCM, in-process
    (the reference's `ffmpeg -map 0:v -map 1:a -c:v copy -shortest`
    listening-copy mux, overlay.py): video packets stream-copied, audio
    AAC-encoded and stopped at the video's end. Returns True; raises
    BuildError when the shim does not build, ValueError on a mux error."""
    lib = load("media_mux")
    a = np.ascontiguousarray(np.asarray(audio, np.float32))
    rc = lib.l2s_mux_overlay(
        str(video_path).encode(),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(a),
        int(sr), str(out_path).encode())
    if rc != 0:
        raise ValueError(f"mux of {video_path} + audio failed: "
                         f"{_MUX_ERRORS.get(rc, f'code {rc}')}")
    return True
