"""WAV read and write without external audio libraries (the port's own copy
of the JAX package's utils/audio_io.py)."""

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


def write_wav(path: str | Path, data: np.ndarray, sample_rate: int) -> None:
    """Write a float array in [-1, 1] (or int16) as 16-bit PCM WAV."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = np.clip(data, -1.0, 1.0 - 1.0 / MAX_WAV_VALUE)
        data = (data * MAX_WAV_VALUE).astype(np.int16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(data.tobytes())


def peak_normalize(data: np.ndarray, target: float = 0.95) -> np.ndarray:
    """librosa.util.normalize(audio) * target: the vocoder's input convention."""
    peak = np.max(np.abs(data))
    if peak == 0:
        return data
    return data / peak * target
