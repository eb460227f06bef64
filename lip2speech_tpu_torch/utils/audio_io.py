"""WAV reading without external audio libraries (the port's own copy of what
unit extraction reads from the JAX package's utils/audio_io.py)."""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

MAX_WAV_VALUE = 32768.0


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array in [-1, 1), sample_rate); PCM16 is
    scaled by 1/32768. Multi-channel audio is returned as (T, C)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / MAX_WAV_VALUE
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels)
    return data, sr
