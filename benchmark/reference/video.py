"""The serving path's input preparation, plain NumPy: uint8 (T, H, W) mouth
frames -> the centre 88 x 88 crop, (x / 255 - 0.421) / 0.165, float32."""

from __future__ import annotations

import numpy as np

MEAN, STD = 0.421, 0.165


def prepare(frames: np.ndarray, size: int = 88) -> np.ndarray:
    t, h, w = frames.shape
    dh, dw = int(round(h - size) / 2.0), int(round(w - size) / 2.0)
    x = frames[:, dh: dh + size, dw: dw + size].astype(np.float32) / 255.0
    return (x - MEAN) / STD
