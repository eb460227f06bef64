"""Viola-Jones Haar-cascade face detection on a NumPy integral image (the
port's own copy of the JAX package's pipeline/haar.py).

The serving envelope needs raw-video face localization (reference
`face_landmarks_server.py:55-347` runs a dlib CNN). OpenCV distributes
*trained cascade models* (HAAR_DIRS below); this file is their evaluator,
so no cv2 build with `objdetect` is needed: new-format (`opencv-cascade-
classifier`) XML parsing plus a vectorized staged classifier over an image
pyramid. Host-side preparation code (like mouth_crop), not device math.

Evaluation semantics mirror OpenCV's `HaarEvaluator`/`predictOrdered`:
  * features are axis-aligned rect sums at the 20x20 base window, weights
    as stored (they already zero out on constant patches);
  * per-window variance normalization over normrect=(1,1,w-2,h-2):
    val = sum_i(w_i * rectsum_i) / sqrt(area*sqsum - sum^2);
  * weak classifiers are small decision trees over `internalNodes`
    (left right featureIdx threshold), leaf index = -idx;
  * a stage rejects the window when its leaf-value sum < stageThreshold;
  * scale space = resizing the IMAGE, window fixed (pyramid approach).

Only the detection-quality knobs the pipeline needs are exposed
(scale_factor / min_neighbors / min_size / stride).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np

HAAR_DIRS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
)


def find_cascade_file(name: str) -> str | None:
    """Locate a shipped cascade XML (e.g. 'haarcascade_frontalface_alt2')."""
    fname = name if name.endswith(".xml") else name + ".xml"
    for d in HAAR_DIRS:
        p = os.path.join(d, fname)
        if os.path.isfile(p):
            return p
    return None


@dataclass
class _Stage:
    threshold: float
    weak_lo: int
    weak_hi: int


class HaarCascade:
    """Parsed new-format cascade + vectorized multi-scale detection."""

    def __init__(self, xml_path: str):
        root = ET.parse(xml_path).getroot()
        casc = root.find("cascade")
        if casc is None or casc.find("stageType") is None or \
                casc.find("stageType").text.strip() != "BOOST" or \
                casc.find("featureType").text.strip() != "HAAR":
            raise ValueError(f"{xml_path}: not a new-format BOOST/HAAR cascade")
        self.win_h = int(casc.find("height").text)
        self.win_w = int(casc.find("width").text)

        # features -> (F, 3, 5) [x, y, w, h, weight], weight 0 pads
        feats = []
        for f in casc.find("features"):
            if f.find("tilted") is not None and \
                    int(f.find("tilted").text) != 0:
                raise ValueError(f"{xml_path}: tilted features unsupported")
            rects = [[float(x) for x in r.text.split()]
                     for r in f.find("rects")]
            while len(rects) < 3:
                rects.append([0.0, 0.0, 0.0, 0.0, 0.0])
            feats.append(rects[:3])
        self.rects = np.asarray(feats, np.float64)        # (F, 3, 5)

        # weak classifiers: flat node/leaf tables + per-weak offsets
        nodes, leaves, self.weak_node_ofs, self.weak_leaf_ofs = [], [], [], []
        self.stages: list[_Stage] = []
        for st in casc.find("stages"):
            lo = len(self.weak_node_ofs)
            for wc in st.find("weakClassifiers"):
                self.weak_node_ofs.append(len(nodes))
                self.weak_leaf_ofs.append(len(leaves))
                vals = wc.find("internalNodes").text.split()
                for i in range(0, len(vals), 4):
                    nodes.append((int(vals[i]), int(vals[i + 1]),
                                  int(vals[i + 2]), float(vals[i + 3])))
                leaves.extend(float(v) for v in
                              wc.find("leafValues").text.split())
            self.stages.append(_Stage(float(st.find("stageThreshold").text),
                                      lo, len(self.weak_node_ofs)))
        self.node_left = np.asarray([n[0] for n in nodes], np.int32)
        self.node_right = np.asarray([n[1] for n in nodes], np.int32)
        self.node_feat = np.asarray([n[2] for n in nodes], np.int32)
        self.node_thresh = np.asarray([n[3] for n in nodes], np.float64)
        self.leaves = np.asarray(leaves, np.float64)
        self.weak_node_ofs = np.asarray(self.weak_node_ofs, np.int32)
        self.weak_leaf_ofs = np.asarray(self.weak_leaf_ofs, np.int32)
        # max tree depth bound: nodes per weak
        counts = np.diff(np.append(self.weak_node_ofs, len(nodes)))
        self.max_nodes_per_weak = int(counts.max()) if len(counts) else 1
        # per-stage precomputation for the batched evaluator: every node of
        # the stage is evaluated in ONE gather pass (a rejected-window loop
        # per weak classifier would be ~100x more Python dispatch)
        self._stage_nodes = []
        n_end = len(self.node_feat)
        for st in self.stages:
            lo = self.weak_node_ofs[st.weak_lo]
            hi = (self.weak_node_ofs[st.weak_hi]
                  if st.weak_hi < len(self.weak_node_ofs) else n_end)
            self._stage_nodes.append((int(lo), int(hi)))

    # -- single-scale core ---------------------------------------------------

    def _detect_at_scale(self, gray: np.ndarray, stride: int):
        """Window top-left coords passing all stages, at this resolution."""
        h, w = gray.shape
        wh, ww = self.win_h, self.win_w
        if h < wh or w < ww:
            return np.empty(0, np.intp), np.empty(0, np.intp)
        g = gray.astype(np.float64)
        ii = np.zeros((h + 1, w + 1), np.float64)
        ii[1:, 1:] = g.cumsum(0).cumsum(1)
        ii2 = np.zeros((h + 1, w + 1), np.float64)
        ii2[1:, 1:] = (g * g).cumsum(0).cumsum(1)

        ys = np.arange(0, h - wh + 1, stride)
        xs = np.arange(0, w - ww + 1, stride)
        wy, wx = (a.ravel() for a in np.meshgrid(ys, xs, indexing="ij"))

        # variance normalization over normrect (1, 1, w-2, h-2)
        nx0, ny0, nx1, ny1 = 1, 1, ww - 1, wh - 1
        area = float((nx1 - nx0) * (ny1 - ny0))
        s = (ii[wy + ny1, wx + nx1] - ii[wy + ny0, wx + nx1]
             - ii[wy + ny1, wx + nx0] + ii[wy + ny0, wx + nx0])
        s2 = (ii2[wy + ny1, wx + nx1] - ii2[wy + ny0, wx + nx1]
              - ii2[wy + ny1, wx + nx0] + ii2[wy + ny0, wx + nx0])
        nf = area * s2 - s * s
        inv_nf = np.where(nf > 0.0, 1.0 / np.sqrt(np.maximum(nf, 1e-12)), 1.0)

        for si, stage in enumerate(self.stages):
            if len(wy) == 0:
                break
            n0, n1 = self._stage_nodes[si]
            # ALL the stage's node features in one gather pass: (K, N)
            feat_ids = self.node_feat[n0:n1]
            rr = self.rects[feat_ids]                       # (K, 3, 5)
            vals = np.zeros((n1 - n0, len(wy)), np.float64)
            for r in range(rr.shape[1]):
                x, y, w, h, wt = (rr[:, r, 0].astype(np.intp),
                                  rr[:, r, 1].astype(np.intp),
                                  rr[:, r, 2].astype(np.intp),
                                  rr[:, r, 3].astype(np.intp),
                                  rr[:, r, 4])
                live = wt != 0.0
                if not live.any():
                    continue
                yl, xl = (y + h)[:, None], (x + w)[:, None]
                y0c, x0c = y[:, None], x[:, None]
                s = (ii[wy[None, :] + yl, wx[None, :] + xl]
                     - ii[wy[None, :] + y0c, wx[None, :] + xl]
                     - ii[wy[None, :] + yl, wx[None, :] + x0c]
                     + ii[wy[None, :] + y0c, wx[None, :] + x0c])
                vals += wt[:, None] * s
            vals *= inv_nf[None, :]
            go_left = vals < self.node_thresh[n0:n1, None]  # (K, N)

            # tree traversal over precomputed decisions (OpenCV
            # predictOrdered: idx = val < thresh ? left : right while
            # idx > 0; leaf index = -idx)
            ssum = np.zeros(len(wy), np.float64)
            col = np.arange(len(wy))
            left, right = self.node_left[n0:n1], self.node_right[n0:n1]
            for wk in range(stage.weak_lo, stage.weak_hi):
                w0 = self.weak_node_ofs[wk] - n0
                w1 = (self.weak_node_ofs[wk + 1] - n0
                      if wk + 1 < len(self.weak_node_ofs)
                      else n1 - n0)
                if w1 - w0 == 1:  # stump fast path
                    idx = np.where(go_left[w0], left[w0], right[w0])
                else:
                    idx = np.zeros(len(wy), np.int32)
                    done = np.zeros(len(wy), bool)
                    for _ in range(w1 - w0):
                        cur = np.where(done, 0, idx) + w0
                        nxt = np.where(go_left[cur, col],
                                       left[cur], right[cur])
                        idx = np.where(done, idx, nxt)
                        done |= idx <= 0
                        if done.all():
                            break
                ssum += self.leaves[self.weak_leaf_ofs[wk] - idx]
            keep = ssum >= stage.threshold
            wy, wx, inv_nf = wy[keep], wx[keep], inv_nf[keep]
        return wy, wx

    # -- public API ----------------------------------------------------------

    def detect(self, gray: np.ndarray, scale_factor: float = 1.15,
               min_neighbors: int = 3, min_size: int = 24,
               max_size: int | None = None, stride: int = 2):
        """Multi-scale detection -> list of (x0, y0, x1, y1) int boxes."""
        gray = np.asarray(gray)
        if gray.ndim == 3:
            gray = gray.mean(axis=-1)
        h, w = gray.shape
        max_size = max_size or max(h, w)
        raw = []
        scale = max(min_size / self.win_w, 1.0)
        while self.win_w * scale <= min(max_size, min(h, w)):
            sh, sw = int(round(h / scale)), int(round(w / scale))
            if sh < self.win_h or sw < self.win_w:
                break
            small = _resize_gray(gray, sh, sw)
            wy, wx = self._detect_at_scale(small, stride)
            for y, x in zip(wy, wx):
                raw.append((x * scale, y * scale,
                            (x + self.win_w) * scale,
                            (y + self.win_h) * scale))
            scale *= scale_factor
        return group_boxes(raw, min_neighbors)


def _resize_gray(g: np.ndarray, sh: int, sw: int) -> np.ndarray:
    """Bilinear resize without cv2 (the build here lacks some modules;
    stay independent of which)."""
    h, w = g.shape
    yy = (np.arange(sh) + 0.5) * (h / sh) - 0.5
    xx = (np.arange(sw) + 0.5) * (w / sw) - 0.5
    y0 = np.clip(np.floor(yy).astype(np.intp), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(np.intp), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]
    g = g.astype(np.float32)
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x1] * fx
    bot = g[y1][:, x0] * (1 - fx) + g[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def group_boxes(boxes, min_neighbors: int = 3):
    """Cluster raw hits; keep clusters with enough neighbors.

    OpenCV's groupRectangles equivalence relation: two boxes merge when
    they differ by < eps * smaller-size in every coordinate (eps=0.2 as
    its default); cluster box = coordinate mean, weight = cluster size.
    Rejection matches OpenCV's `n <= groupThreshold` (i.e. a cluster needs
    min_neighbors + 1 members to survive; min_neighbors=0 keeps all).
    Returns [(x0, y0, x1, y1, n_neighbors)] sorted by n desc.
    """
    if not boxes:
        return []
    boxes = np.asarray(boxes, np.float64)
    n = len(boxes)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    wsz = np.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    for i in range(n):
        for j in range(i + 1, n):
            delta = 0.2 * min(wsz[i], wsz[j])
            if np.all(np.abs(boxes[i] - boxes[j]) <= delta):
                pi, pj = find(i), find(j)
                if pi != pj:
                    parent[pi] = pj
    clusters: dict[int, list[int]] = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(i)
    out = []
    for members in clusters.values():
        if min_neighbors > 0 and len(members) <= min_neighbors:
            continue
        m = boxes[members].mean(axis=0)
        out.append((int(round(m[0])), int(round(m[1])),
                    int(round(m[2])), int(round(m[3])), len(members)))
    out.sort(key=lambda b: -b[4])
    return out


class CascadeFaceDetector:
    """Frontal + profile (both orientations) cascade face detector.

    Returns the strongest face box or None. Profile hits are weaker
    evidence than frontal ones (the profile cascade false-alarms more),
    so frontal wins ties.
    """

    def __init__(self, min_neighbors: int = 2, scale_factor: float = 1.15,
                 stride: int = 2):
        # min_neighbors follows OpenCV groupThreshold semantics (a cluster
        # needs min_neighbors+1 raw hits); default 2 = OpenCV's common
        # detectMultiScale setting and the pre-fix effective behavior here
        self.min_neighbors = min_neighbors
        self.scale_factor = scale_factor
        self.stride = stride
        self._cascades = []
        for name, kind in (("haarcascade_frontalface_alt2", "frontal"),
                           ("haarcascade_profileface", "profile")):
            p = find_cascade_file(name)
            if p is not None:
                self._cascades.append((HaarCascade(p), kind))
        if not self._cascades:
            raise FileNotFoundError(
                "no cascade XMLs found under " + " or ".join(HAAR_DIRS))

    @staticmethod
    def available() -> bool:
        return find_cascade_file("haarcascade_frontalface_alt2") is not None \
            or find_cascade_file("haarcascade_profileface") is not None

    def __call__(self, gray: np.ndarray, min_size: int = 24,
                 return_pose: bool = False):
        """Best face box, or None. With return_pose, returns (box, pose)
        where pose is 'frontal', 'left' (subject faces image-left — the
        unmirrored profile cascade fired) or 'right' (mirrored)."""
        gray = np.asarray(gray)
        if gray.ndim == 3:
            gray = gray.mean(axis=-1)
        best, best_key, best_pose = None, None, None
        for casc, kind in self._cascades:
            views = [(gray, False)]
            if kind == "profile":
                views.append((gray[:, ::-1], True))
            for g, mirrored in views:
                for x0, y0, x1, y1, nn in casc.detect(
                        g, self.scale_factor, self.min_neighbors,
                        min_size=min_size, stride=self.stride):
                    if mirrored:
                        x0, x1 = gray.shape[1] - x1, gray.shape[1] - x0
                    key = (1 if kind == "frontal" else 0, nn)
                    if best_key is None or key > best_key:
                        best_key, best = key, (x0, y0, x1, y1)
                        best_pose = ("frontal" if kind == "frontal"
                                     else ("right" if mirrored else "left"))
        return (best, best_pose) if return_pose else best
