"""Video IO (the port's own copy of the JAX package's data/video_io.py;
numpy only).

The videos are pre-cropped 96x96 grayscale mouth-ROI clips at 25 fps. Sources,
in order:

  1. a `.npy` sidecar next to the video (same stem): (T, H, W) uint8, the
     format this package's dataset writers produce;
  2. a raw `.gray` file: a 12-byte header (T, H, W as little-endian int32),
     then the uint8 frames;
  3. for mp4 only, a decoder: cv2.VideoCapture, else imageio (with an ffmpeg
     or pyav backend). That is a choice of decoder, not of device.

A machine without cv2 and imageio (the GPU machine the smoke run uses has
neither) reads `.npy` and `.gray` only. Grayscale conversion uses the ITU-R
BT.601 luma weights, as cv2.cvtColor(..., COLOR_BGR2GRAY) does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)  # RGB order


def rgb_to_gray(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB -> (T, H, W) uint8 via BT.601 luma (cv2 rounding)."""
    gray = frames.astype(np.float32) @ LUMA
    return np.clip(np.round(gray), 0, 255).astype(np.uint8)


def _try_cv2(path: Path) -> np.ndarray | None:
    try:
        import cv2
    except ImportError:
        return None
    if not hasattr(cv2, "VideoCapture"):  # a bare namespace package
        return None
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return None
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))   # cv2 yields BGR
        ok, frame = cap.read()
    cap.release()
    return np.stack(frames) if frames else None


def _try_imageio(path: Path) -> np.ndarray | None:
    try:
        import imageio.v3 as iio

        arr = iio.imread(path, plugin="pyav")  # (T, H, W, C)
    except Exception:
        try:
            import imageio

            reader = imageio.get_reader(str(path))
            arr = np.stack([f for f in reader])
        except Exception:
            return None
    if arr.ndim == 4 and arr.shape[-1] == 3:
        return rgb_to_gray(arr)
    if arr.ndim == 4 and arr.shape[-1] == 1:
        return arr[..., 0]
    return arr


def load_video_gray(path: str | Path) -> np.ndarray:
    """Load a video as (T, H, W) uint8 grayscale frames."""
    path = Path(path)
    npy = path.with_suffix(".npy")
    if npy.exists():
        arr = np.load(npy)
        if arr.ndim == 4:
            arr = rgb_to_gray(arr) if arr.shape[-1] == 3 else arr[..., 0]
        return arr.astype(np.uint8)
    if path.suffix == ".gray" and path.exists():
        raw = path.read_bytes()
        t, h, w = np.frombuffer(raw[:12], dtype="<i4")
        return np.frombuffer(raw[12:], dtype=np.uint8).reshape(t, h, w).copy()
    if path.exists():
        arr = _try_cv2(path)
        if arr is None:
            arr = _try_imageio(path)
        if arr is not None:
            return arr.astype(np.uint8)
    raise FileNotFoundError(
        f"cannot load video {path}: no .npy sidecar and no mp4 decoder "
        f"(install cv2 or imageio-ffmpeg, or provide {npy})")


def save_video_gray(path: str | Path, frames: np.ndarray) -> None:
    """Save (T, H, W) uint8 frames as the .npy sidecar format."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path.with_suffix(".npy"), frames.astype(np.uint8))
