"""Inference half of the in-tree ERT shape predictor (the port's own copy
of the JAX package's pipeline/ert.py, prediction only, plus
`pad_inner_to_68` from its cli/shape_predictor.py).

An ERT model is the Kazemi-Sullivan cascade of gradient-boosted regression
trees over pixel-difference features ("One Millisecond Face Alignment with
an Ensemble of Regression Trees", CVPR 2014), the algorithm
dlib.train_shape_predictor runs, stored as a plain .npz. Shapes live in a
face-box-normalized frame (box -> unit square); each cascade level reads
its pool pixels, anchored to mean-shape landmarks and warped through the
similarity from the mean shape to the current estimate, and adds the leaf
residuals of its trees (complete binary trees, so prediction is a handful
of vectorized gathers). Training (train_ert and the imglab XML reader)
stays in the JAX package until its cli/shape_predictor.py is ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

INNER_FACE_START = 27  # eyes + nose + mouth (reference keeps landmarks[27:])


def pad_inner_to_68(inner: np.ndarray) -> np.ndarray:
    """Serving-time padding: a custom inner-face predictor outputs 41 points;
    pad jaw/brow slots with zeros to keep the 68-pt interface
    (face_landmarks_server.py custom-predictor path)."""
    out = np.zeros((68, 2), inner.dtype)
    out[INNER_FACE_START:] = inner
    return out


# --------------------------------------------------------------------------
# geometry helpers


def _unit_to_box(points: np.ndarray, box) -> np.ndarray:
    left, top, right, bottom = box
    w = max(float(right - left), 1.0)
    h = max(float(bottom - top), 1.0)
    out = np.empty_like(points, dtype=np.float64)
    out[..., 0] = points[..., 0] * w + left
    out[..., 1] = points[..., 1] * h + top
    return out


def _similarity(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity transform (scale-rotation M, translation t)
    with dst ~= src @ M.T + t. Closed form (Umeyama without reflection
    handling — shapes never mirror between cascade iterations)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    s = src - mu_s
    d = dst - mu_d
    # complex-number form of the 2D similarity LSQ: (a + ib) * s = d
    denom = float((s * s).sum()) or 1.0
    a = float((s * d).sum()) / denom
    b = float((s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0]).sum()) / denom
    m = np.array([[a, -b], [b, a]])
    t = mu_d - mu_s @ m.T
    return m, t


def _read_pixels(image: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Nearest-pixel intensity reads with border clamping; pts in image
    coordinates, shape (..., 2). dlib also reads single pixels (no
    interpolation) — the trees threshold differences, so sub-pixel accuracy
    buys nothing."""
    h, w = image.shape[:2]
    xs = np.clip(np.rint(pts[..., 0]).astype(np.int64), 0, w - 1)
    ys = np.clip(np.rint(pts[..., 1]).astype(np.int64), 0, h - 1)
    return image[ys, xs].astype(np.float64)


# --------------------------------------------------------------------------
# model


class ErtModel:
    """A trained cascade. Per level:
      anchors   (P,) int    nearest mean-shape landmark per pool pixel
      deltas    (P, 2)      offset from that landmark (mean-shape frame)
      splits    (K, I, 3)   [pix_a, pix_b, threshold] per internal node
                            (complete binary tree, I = 2^depth - 1)
      leaves    (K, 2^depth, L, 2) residual added when the leaf fires
    """

    def __init__(self, mean_shape: np.ndarray, levels: list[dict],
                 tree_depth: int):
        self.mean_shape = np.asarray(mean_shape, np.float64)
        self.levels = levels
        self.tree_depth = int(tree_depth)

    # -- persistence -------------------------------------------------------

    @classmethod
    def load(cls, path: str | Path) -> "ErtModel":
        z = np.load(path)
        levels = []
        for i in range(int(z["n_levels"])):
            levels.append({k: z[f"L{i}_{k}"]
                           for k in ("anchors", "deltas", "split_pix",
                                     "split_thr", "leaves")})
        return cls(z["mean_shape"], levels, int(z["tree_depth"]))

    # -- inference ---------------------------------------------------------

    def predict(self, image: np.ndarray, box) -> np.ndarray:
        """Landmarks (L, 2) in image coordinates for a face box."""
        return self.predict_batch([image], [box])[0]

    def predict_batch(self, images, boxes) -> list[np.ndarray]:
        shapes = np.repeat(self.mean_shape[None], len(images), axis=0)
        for lv in self.levels:
            feats = _extract_features(images, boxes, shapes,
                                      self.mean_shape, lv["anchors"],
                                      lv["deltas"])
            shapes = shapes + _forest_predict(
                feats, lv["split_pix"], lv["split_thr"], lv["leaves"],
                self.tree_depth)
        return [_unit_to_box(shapes[i], boxes[i])
                for i in range(len(images))]


def _extract_features(images, boxes, shapes, mean_shape, anchors, deltas):
    """Intensities at the pool pixels warped to each current shape estimate.

    shapes: (N, L, 2) normalized. Returns (N, P)."""
    n = shapes.shape[0]
    out = np.empty((n, anchors.shape[0]))
    for i in range(n):
        m, _t = _similarity(mean_shape, shapes[i])
        pts = shapes[i][anchors] + deltas @ m.T      # normalized frame
        out[i] = _read_pixels(images[i], _unit_to_box(pts, boxes[i]))
    return out


def _forest_predict(feats, split_pix, split_thr, leaves, depth):
    """Sum of leaf residuals over the level's boosted trees.

    feats (N, P); split_pix (K, I, 2); split_thr (K, I); leaves
    (K, 2^depth, L, 2). Vectorized over samples; trees loop (K is small)."""
    n = feats.shape[0]
    total = np.zeros((n,) + leaves.shape[2:])
    for k in range(split_pix.shape[0]):
        node = np.zeros(n, np.int64)
        for _ in range(depth):
            a = split_pix[k, node, 0]
            b = split_pix[k, node, 1]
            go_left = (feats[np.arange(n), a] - feats[np.arange(n), b]
                       > split_thr[k, node])
            node = 2 * node + np.where(go_left, 1, 2)
        leaf = node - (2 ** depth - 1)
        total += leaves[k, leaf]
    return total
