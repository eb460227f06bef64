"""Mouth-ROI extraction from facial landmarks (host-side numpy): the port's
own copy of the JAX package's pipeline/mouth_crop.py.

Rebuild of reference avhubert/preparation/align_mouth.py:24-254 (the crop
geometry the models were trained on — SURVEY.md §7 notes geometry parity
matters more than detector identity):

  * landmark interpolation across undetected frames (linear + edge-hold)
  * sliding-window landmark smoothing (window_margin = 12 frames)
  * similarity warp (Umeyama, with scale) of each frame onto the 256x256
    mean-face using stable points [33, 36, 39, 42, 45]
  * 96x96 crop centered on the mean of warped landmarks 48..67, with the
    reference's boundary clamping (threshold 5)

The face/landmark DETECTOR itself (dlib CNN in the reference) is a pluggable
host dependency: any (T, 68, 2) landmark source works.
"""

from __future__ import annotations

import numpy as np

STABLE_POINTS = (33, 36, 39, 42, 45)
STD_SIZE = (256, 256)


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Umeyama similarity transform (rotation+scale+translation) src -> dst.

    Returns a 3x3 homogeneous matrix M with [x', y', 1]^T = M @ [x, y, 1]^T.
    Matches skimage.transform.estimate_transform('similarity', ...).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones(d)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sign[-1] = -1
    rot = u @ np.diag(sign) @ vt
    var_src = (src_c ** 2).sum() / n
    scale = (s * sign).sum() / var_src
    t = dst_mean - scale * rot @ src_mean
    m = np.eye(3)
    m[:2, :2] = scale * rot
    m[:2, 2] = t
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:2, :2].T + m[:2, 2]


def warp_image(img: np.ndarray, m: np.ndarray, out_shape=STD_SIZE,
               origin=(0, 0)) -> np.ndarray:
    """Warp img with forward transform m (src->dst), bilinear, uint8 out.

    Equivalent to skimage tf.warp(img, inverse_map=tform.inverse,
    output_shape=...) * 255 round-trip in align_mouth.py:33-44.
    Coordinates are (x=col, y=row) like skimage transforms. `origin` offsets
    the output window on the destination canvas: warping only the patch that
    cut_patch would keep samples identical values at ~7x fewer points.
    """
    h_out, w_out = out_shape
    inv = np.linalg.inv(m)
    ys, xs = np.mgrid[0:h_out, 0:w_out]
    coords = np.stack([xs.ravel() + origin[0], ys.ravel() + origin[1]],
                      axis=1).astype(np.float64)
    src = transform_points(inv, coords)          # (N, 2) x,y in source
    sx, sy = src[:, 0], src[:, 1]

    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0

    def _at(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yy = np.clip(yy, 0, h - 1)
        xx = np.clip(xx, 0, w - 1)
        vals = img[yy, xx].astype(np.float64)
        if img.ndim == 3:
            return np.where(valid[:, None], vals, 0.0)
        return np.where(valid, vals, 0.0)

    if img.ndim == 3:
        fx = fx[:, None]
        fy = fy[:, None]
    out = ((1 - fx) * (1 - fy) * _at(y0, x0)
           + fx * (1 - fy) * _at(y0, x0 + 1)
           + (1 - fx) * fy * _at(y0 + 1, x0)
           + fx * fy * _at(y0 + 1, x0 + 1))
    out_shape_full = (h_out, w_out) + img.shape[2:]
    # the reference's (warped*255).astype('uint8') TRUNCATES — reproduce that
    return np.clip(out.reshape(out_shape_full), 0, 255).astype(np.uint8)


def patch_center(canvas_hw, landmarks: np.ndarray, height: int, width: int,
                 threshold: int = 5) -> tuple[int, int]:
    """Patch center (cy, cx) on a canvas of shape canvas_hw around the
    landmark centroid, with the reference's clamp/raise behavior
    (align_mouth.py:63-95)."""
    center_x, center_y = np.mean(landmarks, axis=0)
    if center_y - height < 0:
        center_y = height
    if center_y - height < 0 - threshold:
        raise ValueError("too much bias in height")
    if center_x - width < 0:
        center_x = width
    if center_x - width < 0 - threshold:
        raise ValueError("too much bias in width")
    if center_y + height > canvas_hw[0]:
        center_y = canvas_hw[0] - height
    if center_y + height > canvas_hw[0] + threshold:
        raise ValueError("too much bias in height")
    if center_x + width > canvas_hw[1]:
        center_x = canvas_hw[1] - width
    if center_x + width > canvas_hw[1] + threshold:
        raise ValueError("too much bias in width")
    return int(round(center_y)), int(round(center_x))


def cut_patch(img: np.ndarray, landmarks: np.ndarray, height: int, width: int,
              threshold: int = 5) -> np.ndarray:
    """Crop 2*height x 2*width around the landmark centroid with the
    reference's clamp/raise behavior (align_mouth.py:63-95)."""
    cy, cx = patch_center(img.shape[:2], landmarks, height, width, threshold)
    return img[cy - height : cy + height, cx - width : cx + width]


def interpolate_landmarks(landmarks: list[np.ndarray | None]) -> list[np.ndarray] | None:
    """Fill undetected frames: linear between detections, hold at the edges."""
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    if not valid:
        return None
    out = list(landmarks)
    for a, b in zip(valid[:-1], valid[1:]):
        if b - a > 1:
            delta = out[b] - out[a]
            for i in range(1, b - a):
                out[a + i] = out[a] + (i / float(b - a)) * delta
    for i in range(valid[0]):
        out[i] = out[valid[0]]
    for i in range(valid[-1] + 1, len(out)):
        out[i] = out[valid[-1]]
    return out


def crop_mouth_sequence(
    frames: np.ndarray,
    landmarks: list[np.ndarray | None],
    mean_face: np.ndarray,
    window_margin: int = 12,
    start_idx: int = 48,
    stop_idx: int = 68,
    crop_size: int = 96,
) -> np.ndarray:
    """(T, H, W[, C]) frames + per-frame 68-pt landmarks -> (T, 96, 96[, C]).

    Reproduces the crop_patch deque semantics (align_mouth.py:131-181):
    each frame is warped with the transform estimated from the MEAN of the
    next `window_margin` frames' landmarks; trailing frames reuse the last
    transform.
    """
    lms = interpolate_landmarks(landmarks)
    if lms is None:
        raise ValueError("no landmarks detected in any frame")
    t = len(frames)
    margin = min(t, window_margin)
    stable = list(STABLE_POINTS)
    out = []
    last_m = None
    half = crop_size // 2
    for i in range(t):
        if i + margin <= t:
            window = np.mean([lms[j] for j in range(i, i + margin)], axis=0)
            last_m = estimate_similarity(window[stable], mean_face[stable])
        m = last_m
        warped_lm = transform_points(m, lms[i])
        # warp ONLY the patch cut_patch would keep (same clamp semantics on
        # the 256x256 canvas, identical sampled values, ~7x fewer samples)
        cy, cx = patch_center(STD_SIZE, warped_lm[start_idx:stop_idx],
                              half, half)
        out.append(warp_image(frames[i], m, (crop_size, crop_size),
                              origin=(cx - half, cy - half)))
    return np.stack(out)


_MEAN_FACE_CACHE: np.ndarray | None = None


def default_mean_face() -> np.ndarray:
    """Synthetic 68-pt mean face on the 256x256 canvas.

    Stand-in for 20words_mean_face.npy (external download in the reference);
    pass the real file for bit-parity with published checkpoints. Only the
    stable points (nose bridge + eye corners) and mouth region placement
    matter for the crop geometry. Cached (callers invoke it per frame);
    returns a copy so mutation can't poison the cache.
    """
    global _MEAN_FACE_CACHE
    if _MEAN_FACE_CACHE is not None:
        return _MEAN_FACE_CACHE.copy()
    pts = np.zeros((68, 2), np.float64)
    # jaw 0-16: ellipse
    ang = np.linspace(np.pi, 2 * np.pi, 17)
    pts[0:17, 0] = 128 + 70 * np.cos(ang + np.pi / 2)
    pts[0:17, 1] = 120 + 85 * np.sin(ang + np.pi / 2) * -1
    # brows 17-26
    pts[17:22] = np.stack([np.linspace(78, 118, 5), np.full(5, 78.0)], 1)
    pts[22:27] = np.stack([np.linspace(138, 178, 5), np.full(5, 78.0)], 1)
    # nose 27-35
    pts[27:31] = np.stack([np.full(4, 128.0), np.linspace(92, 128, 4)], 1)
    pts[31:36] = np.stack([np.linspace(112, 144, 5), np.full(5, 140.0)], 1)
    pts[33] = [128.0, 142.0]
    # eyes 36-47
    for base, cx in [(36, 98.0), (42, 158.0)]:
        exs = np.array([-14, -7, 7, 14, 7, -7]) + cx
        eys = np.array([0, -5, -5, 0, 5, 5]) + 96.0
        pts[base : base + 6] = np.stack([exs, eys], 1)
    # mouth 48-67
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    pts[48:60, 0] = 128 + 26 * np.cos(ang)
    pts[48:60, 1] = 172 + 13 * np.sin(ang)
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts[60:68, 0] = 128 + 14 * np.cos(ang)
    pts[60:68, 1] = 172 + 7 * np.sin(ang)
    _MEAN_FACE_CACHE = pts
    return pts.copy()
