"""The in-tree ERT shape predictor, training and prediction (the port's own
copy of the JAX package's pipeline/ert.py, plus `pad_inner_to_68` from its
cli/shape_predictor.py). Numpy on the host: the same options and seed give
the JAX module's model arrays bit for bit.

An ERT model is the Kazemi-Sullivan cascade of gradient-boosted regression
trees over pixel-difference features ("One Millisecond Face Alignment with
an Ensemble of Regression Trees", CVPR 2014), the algorithm
dlib.train_shape_predictor runs, stored as a plain .npz. Shapes live in a
face-box-normalized frame (box -> unit square); each cascade level reads
its pool pixels, anchored to mean-shape landmarks and warped through the
similarity from the mean shape to the current estimate, and adds the leaf
residuals of its trees (complete binary trees, so prediction is a handful
of vectorized gathers).

Training (train_ert) mirrors dlib.train_shape_predictor's structure:
  * each cascade level samples `feature_pool_size` pixel locations once,
    anchored to the nearest mean-shape landmark, and extracts their
    intensities once per level for all of its trees;
  * trees are fit by gradient boosting with shrinkage `nu`;
  * split candidates are pixel-difference tests (I[a] - I[b] > thresh)
    drawn with the exponential proximity prior exp(-||pa - pb|| / lambda)
    of the paper, so nearby pixel pairs are proposed more often.
It consumes the imglab XML that cli/shape_predictor.build_training_xml
writes and exposes the hyperparameters the reference tunes
(train_shape_predictor.py:72-82).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
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


@dataclasses.dataclass
class ErtOptions:
    """Mirrors dlib.shape_predictor_training_options (the fields the
    reference tunes, train_shape_predictor.py:72-82)."""

    tree_depth: int = 3
    nu: float = 0.1
    cascade_depth: int = 8
    feature_pool_size: int = 300
    num_test_splits: int = 20
    oversampling_amount: int = 10
    oversampling_translation_jitter: float = 0.1
    feature_pool_region_padding: float = 0.0
    lambda_param: float = 0.1
    trees_per_cascade: int = 200
    seed: int = 0


def _box_to_unit(points: np.ndarray, box) -> np.ndarray:
    left, top, right, bottom = box
    w = max(float(right - left), 1.0)
    h = max(float(bottom - top), 1.0)
    out = np.empty_like(points, dtype=np.float64)
    out[..., 0] = (points[..., 0] - left) / w
    out[..., 1] = (points[..., 1] - top) / h
    return out


# --------------------------------------------------------------------------
# geometry helpers


def _box_to_unit(points: np.ndarray, box) -> np.ndarray:
    left, top, right, bottom = box
    w = max(float(right - left), 1.0)
    h = max(float(bottom - top), 1.0)
    out = np.empty_like(points, dtype=np.float64)
    out[..., 0] = (points[..., 0] - left) / w
    out[..., 1] = (points[..., 1] - top) / h
    return out


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

    def save(self, path: str | Path) -> None:
        blobs = {"mean_shape": self.mean_shape,
                 "tree_depth": np.int64(self.tree_depth),
                 "n_levels": np.int64(len(self.levels))}
        for i, lv in enumerate(self.levels):
            for k in ("anchors", "deltas", "split_pix", "split_thr",
                      "leaves"):
                blobs[f"L{i}_{k}"] = lv[k]
        np.savez_compressed(path, **blobs)

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


# --------------------------------------------------------------------------
# training


def train_ert(samples, options: ErtOptions | None = None,
              log=lambda s: None) -> ErtModel:
    """samples: list of (image uint8 (H, W), box (l, t, r, b),
    landmarks (L, 2) image coords). Returns the trained cascade."""
    opt = options or ErtOptions()
    rng = np.random.default_rng(opt.seed)

    images = [np.asarray(im) for im, _b, _l in samples]
    boxes = [b for _im, b, _l in samples]
    gt = np.stack([_box_to_unit(np.asarray(lm, np.float64), b)
                   for _im, b, lm in samples])      # (S, L, 2)
    n_samples, n_landmarks = gt.shape[0], gt.shape[1]
    mean_shape = gt.mean(axis=0)

    # oversampling: each training instance starts from a DIFFERENT shape
    # (another sample's ground truth, optionally jittered) so the cascade
    # learns to move shapes, not memorize the mean (dlib's
    # oversampling_amount / oversampling_translation_jitter)
    idx_img, starts, targets = [], [], []
    for s in range(n_samples):
        for r in range(opt.oversampling_amount):
            if r == 0:
                init = mean_shape.copy()
            else:
                init = gt[rng.integers(n_samples)].copy()
                if opt.oversampling_translation_jitter > 0:
                    init = init + rng.uniform(
                        -opt.oversampling_translation_jitter,
                        opt.oversampling_translation_jitter, 2)
            idx_img.append(s)
            starts.append(init)
            targets.append(gt[s])
    idx_img = np.asarray(idx_img)
    current = np.stack(starts)                       # (N, L, 2)
    targets = np.stack(targets)
    inst_images = [images[i] for i in idx_img]
    inst_boxes = [boxes[i] for i in idx_img]

    lo = mean_shape.min(axis=0) - opt.feature_pool_region_padding
    hi = mean_shape.max(axis=0) + opt.feature_pool_region_padding

    levels = []
    n_internal = 2 ** opt.tree_depth - 1
    n_leaves = 2 ** opt.tree_depth
    for level in range(opt.cascade_depth):
        # pixel pool for this level, anchored to nearest mean landmark
        pool = rng.uniform(lo, hi, (opt.feature_pool_size, 2))
        d2 = ((pool[:, None] - mean_shape[None]) ** 2).sum(-1)
        anchors = d2.argmin(axis=1)
        deltas = pool - mean_shape[anchors]

        feats = _extract_features(inst_images, inst_boxes, current,
                                  mean_shape, anchors, deltas)
        residual = targets - current                 # boosting targets

        # proximity prior over candidate pixel pairs (paper eq. 6)
        pdist = np.linalg.norm(pool[:, None] - pool[None], axis=-1)
        prior = np.exp(-pdist / max(opt.lambda_param, 1e-6))
        np.fill_diagonal(prior, 0.0)
        prior_flat = (prior / prior.sum()).ravel()

        split_pix = np.zeros((opt.trees_per_cascade, n_internal, 2),
                             np.int64)
        split_thr = np.zeros((opt.trees_per_cascade, n_internal))
        leaves = np.zeros((opt.trees_per_cascade, n_leaves,
                           n_landmarks, 2))
        for k in range(opt.trees_per_cascade):
            tree_sp, tree_thr, tree_leaves = _fit_tree(
                feats, residual, prior_flat, opt, rng,
                opt.feature_pool_size)
            split_pix[k] = tree_sp
            split_thr[k] = tree_thr
            leaves[k] = tree_leaves
            # boosting: subtract this tree's (shrunk) prediction
            residual = residual - _forest_predict(
                feats, split_pix[k:k + 1], split_thr[k:k + 1],
                leaves[k:k + 1], opt.tree_depth)

        levels.append({"anchors": anchors, "deltas": deltas,
                       "split_pix": split_pix, "split_thr": split_thr,
                       "leaves": leaves})
        current = current + _forest_predict(
            feats, split_pix, split_thr, leaves, opt.tree_depth)
        err = float(np.abs(targets - current).mean())
        log(f"cascade {level + 1}/{opt.cascade_depth}: "
            f"mean |residual| {err:.4f}")

    return ErtModel(mean_shape, levels, opt.tree_depth)


def _fit_tree(feats, residual, prior_flat, opt: ErtOptions, rng, pool_size):
    """One regression tree, greedy level-order construction. Split choice:
    maximize the standard sum-of-squares gain |left|*||mu_l||^2 +
    |right|*||mu_r||^2 over `num_test_splits` prior-sampled candidates."""
    n = feats.shape[0]
    n_internal = 2 ** opt.tree_depth - 1
    split_pix = np.zeros((n_internal, 2), np.int64)
    split_thr = np.zeros(n_internal)
    leaves = np.zeros((2 ** opt.tree_depth,) + residual.shape[1:])

    node_members = {0: np.arange(n)}
    res_flat = residual.reshape(n, -1)
    for node in range(n_internal):
        members = node_members.pop(node, np.empty(0, np.int64))
        best = None
        if members.size >= 2:
            cand = rng.choice(prior_flat.size, opt.num_test_splits,
                              p=prior_flat)
            ca, cb = cand // pool_size, cand % pool_size
            diffs = feats[np.ix_(members, ca)] - feats[np.ix_(members, cb)]
            # dlib draws the threshold uniformly between the observed
            # diff extremes (biased toward the middle); use the median for
            # balance + one uniform draw as a second candidate per pair
            for j in range(opt.num_test_splits):
                d = diffs[:, j]
                for thr in (float(np.median(d)),
                            float(rng.uniform(d.min(), d.max()))
                            if d.max() > d.min() else float(np.median(d))):
                    mask = d > thr
                    nl = int(mask.sum())
                    nr = members.size - nl
                    if nl == 0 or nr == 0:
                        continue
                    mu_l = res_flat[members[mask]].mean(axis=0)
                    mu_r = res_flat[members[~mask]].mean(axis=0)
                    gain = nl * float(mu_l @ mu_l) + nr * float(mu_r @ mu_r)
                    if best is None or gain > best[0]:
                        best = (gain, ca[j], cb[j], thr, mask)
        if best is None:
            # degenerate node: send everything right with an impossible test
            split_pix[node] = (0, 0)
            split_thr[node] = np.inf
            mask = np.zeros(members.size, bool)
        else:
            _g, pa, pb, thr, mask = best
            split_pix[node] = (pa, pb)
            split_thr[node] = thr
        node_members[2 * node + 1] = members[mask]
        node_members[2 * node + 2] = members[~mask]

    for leaf in range(2 ** opt.tree_depth):
        members = node_members.get(n_internal + leaf,
                                   np.empty(0, np.int64))
        if members.size:
            leaves[leaf] = opt.nu * residual[members].mean(axis=0)
    return split_pix, split_thr, leaves


# --------------------------------------------------------------------------
# imglab XML interop (the trainer consumes what
# cli/shape_predictor.build_training_xml writes, mirroring
# dlib.train_shape_predictor's XML-path interface)


def load_imglab_xml(xml_path: str | Path):
    """Returns list of (image_path, box (l, t, r, b), parts (L, 2))."""
    root = ET.parse(str(xml_path)).getroot()
    out = []
    for image in root.iter("image"):
        path = image.get("file")
        for box in image.iter("box"):
            left = int(box.get("left"))
            top = int(box.get("top"))
            right = left + int(box.get("width"))
            bottom = top + int(box.get("height"))
            parts = sorted(box.iter("part"), key=lambda p: p.get("name"))
            pts = np.array([[float(p.get("x")), float(p.get("y"))]
                            for p in parts])
            out.append((path, (left, top, right, bottom), pts))
    return out


def imread_gray(path: str | Path) -> np.ndarray:
    """Grayscale (H, W) uint8 image read: .npy arrays natively (the dataset
    builder's sidecar format), anything else via PIL."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
    else:
        from PIL import Image

        arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        from lip2speech_tpu_torch.data.video_io import rgb_to_gray

        arr = rgb_to_gray(arr[None, ..., :3])[0]
    return arr.astype(np.uint8)


def train_from_xml(xml_path: str | Path, model_path: str | Path,
                   options: ErtOptions | None = None,
                   log=lambda s: None) -> ErtModel:
    samples = []
    for path, box, pts in load_imglab_xml(xml_path):
        samples.append((imread_gray(path), box, pts))
    model = train_ert(samples, options, log=log)
    model.save(model_path)
    return model


def evaluate_error(model: ErtModel, samples) -> float:
    """Mean per-landmark error normalized by face-box width — the analogue
    of dlib.test_shape_predictor's average error (reference
    train_shape_predictor.py:55-63)."""
    errs = []
    for image, box, lm in samples:
        pred = model.predict(np.asarray(image), box)
        w = max(float(box[2] - box[0]), 1.0)
        errs.append(np.linalg.norm(pred - np.asarray(lm), axis=-1).mean()
                    / w)
    return float(np.mean(errs))
