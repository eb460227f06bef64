"""Batched affine warp + crop on the device (JAX reference: ops/warp.py).

The device half of the mouth-ROI extraction geometry
(pipeline/mouth_crop.py): instead of warping each frame onto the 256x256
mean-face canvas and then cropping 96x96, compose the similarity transform
with the crop offset and sample ONLY the 96x96 output pixels, one bilinear
sample per output pixel, batched over the clip.

Equivalent to crop_mouth_sequence up to the output-grid composition (the
host path warps to uint8 first, then crops; here the crop box is computed
from the same warped landmarks and sampled directly at full precision, then
truncated to uint8 identically).
"""

from __future__ import annotations

import numpy as np
import torch

from lip2speech_tpu_torch.pipeline.mouth_crop import (
    STABLE_POINTS,
    STD_SIZE,
    estimate_similarity,
    interpolate_landmarks,
    transform_points,
)


def _bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """img (T, H, W); xs / ys (T, h, w) source coords -> (T, h, w), zeros
    outside the image."""
    t, h, w = img.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(t, h * w)

    def at(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(t, -1)
        vals = torch.gather(flat, 1, idx).reshape(yy.shape)
        return torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    return ((1 - fx) * (1 - fy) * at(y0, x0)
            + fx * (1 - fy) * at(y0, x0 + 1)
            + (1 - fx) * fy * at(y0 + 1, x0)
            + fx * fy * at(y0 + 1, x0 + 1))


def warp_crop_batch(frames: torch.Tensor, matrices: torch.Tensor, centers: torch.Tensor,
                    crop_size: int = 96) -> torch.Tensor:
    """frames (T, H, W), matrices (T, 3, 3) forward similarity (src ->
    canvas), centers (T, 2) crop centers (x, y) on the canvas, all float32
    on one device -> (T, crop, crop) float32 on it:
    canvas[cy-h:cy+h, cx-w:cx+w] per frame."""
    half = crop_size // 2
    grid = torch.arange(crop_size, dtype=torch.float32, device=frames.device)
    # output pixel (r, c) sits at canvas coords (cx - half + c, cy - half + r)
    cx = torch.round(centers[:, 0])[:, None, None]
    cy = torch.round(centers[:, 1])[:, None, None]
    canvas_x = cx - half + grid[None, None, :]
    canvas_y = cy - half + grid[None, :, None]
    inv = torch.linalg.inv(matrices)[:, :2, :, None, None]          # (T, 2, 3, 1, 1)
    src_x = inv[:, 0, 0] * canvas_x + inv[:, 0, 1] * canvas_y + inv[:, 0, 2]
    src_y = inv[:, 1, 0] * canvas_x + inv[:, 1, 1] * canvas_y + inv[:, 1, 2]
    return _bilinear_sample(frames, src_x, src_y)


def crop_transforms(landmarks, mean_face: np.ndarray, window_margin: int = 12,
                    start_idx: int = 48, stop_idx: int = 68,
                    crop_size: int = 96) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame (T, 3, 3) similarity matrices and (T, 2) crop centers of
    crop_mouth_sequence (Umeyama on 5 points over the smoothing window, the
    reference's clamp), computed on the host."""
    lms = interpolate_landmarks(list(landmarks))
    if lms is None:
        raise ValueError("no landmarks detected in any frame")
    t = len(lms)
    margin = min(t, window_margin)
    stable = list(STABLE_POINTS)
    mats = np.zeros((t, 3, 3))
    centers = np.zeros((t, 2))
    last_m = None
    half = crop_size // 2
    h_img = STD_SIZE[0]
    for i in range(t):
        if i + margin <= t:
            window = np.mean([lms[j] for j in range(i, i + margin)], axis=0)
            last_m = estimate_similarity(window[stable], mean_face[stable])
        mats[i] = last_m
        warped_lm = transform_points(last_m, lms[i])[start_idx:stop_idx]
        cx, cy = warped_lm.mean(axis=0)
        # reference clamp (mouth_crop.cut_patch semantics)
        cx = min(max(cx, half), h_img - half)
        cy = min(max(cy, half), h_img - half)
        centers[i] = (cx, cy)
    return mats, centers


def crop_mouth_sequence_device(frames: np.ndarray, landmarks, mean_face: np.ndarray,
                               window_margin: int = 12, start_idx: int = 48,
                               stop_idx: int = 68, crop_size: int = 96,
                               device=None) -> np.ndarray:
    """crop_mouth_sequence with the per-pixel warp on the device: the host
    computes the tiny per-frame transforms (crop_transforms), the warp runs
    batched on the card unless device="cpu"."""
    from lip2speech_tpu_torch.pipeline.synthesise import resolve_device

    dev = resolve_device(device)
    mats, centers = crop_transforms(landmarks, mean_face, window_margin, start_idx, stop_idx,
                                    crop_size)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    out = warp_crop_batch(f32(frames), f32(mats), f32(centers), crop_size)
    return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)
