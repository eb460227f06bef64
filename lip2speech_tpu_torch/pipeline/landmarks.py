"""Facial-landmark providers (host side, pluggable): the port's own copy of
the JAX package's pipeline/landmarks.py, unchanged but for its imports.

The reference runs a Dockerized dlib CNN/HOG landmark server fed over Redis
(face_landmarks_server.py:55-347, detection every 2nd frame with a 1.3x
pre-crop around the previous face, <= 500 px downscale, HOG fallback). dlib
is not in this image, so the detector is a pluggable protocol; the crop
GEOMETRY (what the models actually depend on) lives in pipeline/mouth_crop.py.

Providers:
  PrecomputedLandmarks — .npy/.pkl files of (T, 68, 2) per clip (the format
    the reference's preparation pipeline also writes)
  DlibLandmarks        — wraps dlib when installed, with the reference's
    every-nth-frame + interpolation policy
  HeuristicLandmarks   — in-image-runnable (no dlib): local-variance face
    box (connected components + centrality prior) anchored by the clip's
    MOTION map (talking mouths move; background clutter doesn't), with
    temporal EMA box smoothing + jump/scale rejection, canonical mean-shape
    placement and gradient mouth refinement. The crop geometry consumes only
    the stable points and the mouth-region center, so a box-aligned mean
    shape reproduces the reference's 96x96 mouth ROI for roughly frontal
    faces. Accuracy is quantified on a synthetic-hard benchmark
    (tests/landmark_bench.py; table in QUALITY.md): mean box IoU ~0.84
    in-envelope, mouth-crop IoU ~0.81, center error 3-5% of face width.
    Beyond-envelope rows are quantified too (r4): 30-deg yaw and 20-deg
    roll are full quality (box IoU ~0.91); a 55-deg profile proxy degrades
    to box ~0.55 but keeps crop IoU ~0.76 (the mean shape assumes roughly
    frontal pose); faces down to ~12% of the frame width are recovered by a
    relaxed-floor full-frame retry (box ~0.82). Honest remaining failure
    mode: dense textured clutter adjacent to a STILL face (box inflates
    toward clutter).
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol

import numpy as np

DETECTION_NTH_FRAME = 2   # reference config.py:64
PRE_CROP_SCALE = 1.3      # reference config.py:65


class LandmarkProvider(Protocol):
    def __call__(self, frames: np.ndarray) -> list[np.ndarray | None]:
        """(T, H, W[, C]) frames -> per-frame (68, 2) landmarks or None."""
        ...


class PrecomputedLandmarks:
    """Loads landmarks stored next to (or mirroring) the video tree."""

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def load(self) -> list[np.ndarray | None]:
        if self.path.suffix == ".npy":
            arr = np.load(self.path, allow_pickle=True)
            return [None if lm is None else np.asarray(lm, np.float64)
                    for lm in arr]
        if self.path.suffix == ".pkl":
            import pickle

            with open(self.path, "rb") as f:
                return pickle.load(f)
        raise ValueError(f"unsupported landmark file {self.path}")

    def __call__(self, frames: np.ndarray) -> list[np.ndarray | None]:
        lms = self.load()
        if len(lms) != len(frames):
            raise ValueError(f"{len(lms)} landmark rows vs {len(frames)} frames")
        return lms


class DlibLandmarks:
    """dlib-backed detector with the reference's nth-frame policy. Requires
    dlib + a 68-pt shape predictor; raises ImportError when unavailable."""

    def __init__(self, predictor_path: str, use_cnn: bool = False,
                 cnn_model_path: str | None = None,
                 nth_frame: int = DETECTION_NTH_FRAME):
        import dlib  # optional

        if not hasattr(dlib, "get_frontal_face_detector"):
            # a bare dlib/ directory on sys.path imports as an empty
            # namespace package — treat as unavailable
            raise ImportError("dlib namespace package has no detector API")
        self.detector = (dlib.cnn_face_detection_model_v1(cnn_model_path)
                         if use_cnn else dlib.get_frontal_face_detector())
        self.use_cnn = use_cnn
        self.predictor = dlib.shape_predictor(predictor_path)
        self.nth_frame = nth_frame

    def _detect(self, frame: np.ndarray):
        dets = self.detector(frame, 1)
        if not dets:
            return None
        d = dets[0]
        return d.rect if self.use_cnn else d

    def __call__(self, frames: np.ndarray) -> list[np.ndarray | None]:
        out: list[np.ndarray | None] = []
        rect = None
        for i, frame in enumerate(frames):
            if i % self.nth_frame == 0 or rect is None:
                rect = self._detect(frame)
            if rect is None:
                out.append(None)
                continue
            shape = self.predictor(frame, rect)
            out.append(np.array([[p.x, p.y] for p in shape.parts()], np.float64))
        return out


class ErtLandmarks:
    """In-tree trained shape predictor (pipeline/ert.py) over a face-box
    provider — the dlib-free analogue of the reference's custom-predictor
    serving path (face_landmarks_server.py: detector box -> shape predictor
    -> 68/41-pt landmarks, zero-padded to 68 for inner-face models).

    box_provider: any LandmarkProvider whose output bounding box locates the
    face (default: the trained cascade when available, else the heuristic).
    """

    def __init__(self, model_path: str, box_provider=None,
                 expand: float = 0.0):
        from .ert import ErtModel

        self.model = ErtModel.load(model_path)
        # NOT default_landmarker(): that would recurse when
        # LIP2SPEECH_ERT_PREDICTOR selects this class
        self.box_provider = box_provider or (
            CascadeLandmarks() if CascadeLandmarks.available()
            else HeuristicLandmarks())
        self.expand = expand

    def __call__(self, frames: np.ndarray) -> list[np.ndarray | None]:
        from .ert import pad_inner_to_68

        base = self.box_provider(frames)
        out: list[np.ndarray | None] = []
        for frame, lm in zip(frames, base):
            if lm is None:
                out.append(None)
                continue
            x0, y0 = lm[:, 0].min(), lm[:, 1].min()
            x1, y1 = lm[:, 0].max(), lm[:, 1].max()
            if self.expand:
                dx = self.expand * (x1 - x0)
                dy = self.expand * (y1 - y0)
                x0, y0, x1, y1 = x0 - dx, y0 - dy, x1 + dx, y1 + dy
            pred = self.model.predict(np.asarray(frame), (x0, y0, x1, y1))
            out.append(pad_inner_to_68(pred) if pred.shape[0] == 41
                       else pred)
        return out


def box_iou(a, b) -> float:
    """IoU of two (x0, y0, x1, y1) boxes."""
    if a is None or b is None:
        return 0.0
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def detect_face_box(gray: np.ndarray, min_rel_size: float = 0.15,
                    prior_box=None, motion: np.ndarray | None = None,
                    motion_noise: float | None = None,
                    px_scale: float = 1.0):
    """Face bounding box from a local-variance saliency map.

    Faces are the high-texture blob in a talking-head frame (the serving
    envelope: <= 480x360 close-ups, reference config.py:20-30). Local std is
    computed with box filters and thresholded; CONNECTED COMPONENTS of the
    thresholded map are scored by area x centrality so background clutter and
    corner distractors form separate, lower-scoring components instead of
    inflating one global box. With `prior_box`, detection searches only a
    PRE_CROP_SCALE (1.3x) window around it — the reference's own re-detect
    policy (face_landmarks_server.py:211-240, config.py:65) — and centrality
    is measured from the prior's center.

    `motion` (full-frame, same shape as gray): a temporal-difference energy
    map of the clip. In a talking-head video the MOUTH moves while background
    clutter is static, so the strongest motion hotspot anchors the face:
    components are chosen by distance to the anchor and the box extent is
    restricted to a face-radius neighborhood of it, which cuts static clutter
    that texture saliency alone cannot separate. Ignored when the motion
    signal is at the noise floor (still scenes degrade to the static path).

    `px_scale`: factor by which `gray` was downscaled from the tuned
    full-resolution envelope (HeuristicLandmarks passes detect_downscale).
    The handful of ABSOLUTE pixel constants below (mouth-width clip,
    degenerate-window floor, motion pixel count) were tuned at full res;
    scaling them keeps half-res detection a pure resampling of the
    full-res behavior instead of silently retuning it for small faces.
    Returns (x0, y0, x1, y1) or None.
    """
    from scipy.ndimage import label, uniform_filter

    g = gray
    if g.ndim == 3:
        g = g.mean(axis=-1)
    full_h, full_w = g.shape
    ox = oy = 0
    if prior_box is not None:
        px0, py0, px1, py1 = prior_box
        pw, ph = px1 - px0, py1 - py0
        mx = 0.5 * (PRE_CROP_SCALE - 1.0)
        ox = max(0, int(px0 - mx * pw))
        oy = max(0, int(py0 - mx * ph))
        x_hi = min(full_w, int(px1 + mx * pw))
        y_hi = min(full_h, int(py1 + mx * ph))
        win_floor = max(4, int(round(8 / px_scale)))
        if x_hi - ox < win_floor or y_hi - oy < win_floor:
            ox = oy = 0
        else:
            g = g[oy:y_hi, ox:x_hi]
    h, w = g.shape
    # k from the FULL frame scale even when searching a prior window: a
    # window-relative k weakens edge saliency, shrinking the box a little on
    # every tracked re-detect (compounding collapse)
    # cast AFTER the prior-window crop (filtering the 1.3x window in f32 is
    # ~10x cheaper than full-frame f64; saliency is threshold-based, so f32
    # precision is ample)
    g = g.astype(np.float32)
    k = max(5, min(full_h, full_w) // 10)
    mean = uniform_filter(g, k)
    var = np.clip(uniform_filter(g * g, k) - mean * mean, 0.0, None)
    sal = np.sqrt(var)
    peak = sal.max()
    if peak <= 1e-6:
        return None
    mask = sal > 0.3 * peak
    # connectivity mask: bridge face-internal gaps (smooth forehead/cheeks
    # between the high-variance features/edges) so one face = one component;
    # clutter farther than ~k pixels stays separate. The DILATED mask defines
    # connectivity only — box extent below uses the tight original mask.
    bridged = uniform_filter(mask.astype(np.float32), k) > 0.08
    labels, n = label(bridged)
    if n == 0:
        return None
    # face anchor: the motion hotspot (talking mouth) when the clip has
    # real motion, else the prior box center when tracking, else the frame
    # center
    anchor = None
    mouth_w = None
    motion_box = None       # face-wide motion: the face outlines itself
    if motion is not None:
        mo = motion[oy:oy + h, ox:ox + w]
        # the motion map is clip-static: callers in a tracking loop pass the
        # precomputed median (a full-frame partition per detect otherwise)
        noise = (float(np.median(motion)) if motion_noise is None
                 else motion_noise)
        if mo.size and mo.max() > max(4.0 * noise, 1.0):
            thr = max(0.15 * float(mo.max()), 2.5 * noise)
            mys, mxs = np.nonzero(mo > thr)
            # pixel-count floor scales with AREA under downscaling
            if len(mxs) >= max(3, int(round(8 / px_scale ** 2))):
                bx0, bx1 = np.quantile(mxs, 0.02), np.quantile(mxs, 0.98)
                by0, by1 = np.quantile(mys, 0.02), np.quantile(mys, 0.98)
                if (bx1 - bx0) < 0.3 * w and (by1 - by0) < 0.3 * h:
                    # mouth-sized motion blob: it IS the talking mouth
                    anchor = (0.5 * (bx0 + bx1), 0.5 * (by0 + by1))
                    mouth_w = float(np.clip(bx1 - bx0, 12 / px_scale,
                                            120 / px_scale))
                else:
                    # whole face moves: its motion outline bounds the face
                    motion_box = (bx0, by0, bx1, by1)
                    anchor = (0.5 * (bx0 + bx1), 0.5 * (by0 + by1))
    if anchor is not None:
        cx0, cy0 = anchor
    elif prior_box is not None:
        cx0 = 0.5 * (prior_box[0] + prior_box[2]) - ox
        cy0 = 0.5 * (prior_box[1] + prior_box[3]) - oy
    else:
        cx0, cy0 = 0.5 * w, 0.5 * h
    sigma = 0.5 * max(h, w)
    best, best_score = None, -1.0
    for comp in range(1, n + 1):
        sel = (labels == comp) & mask
        ys, xs = np.nonzero(sel)
        area = len(xs)
        if area < (min_rel_size * min(h, w)) ** 2 * 0.25:
            continue
        cx, cy = xs.mean(), ys.mean()
        centrality = np.exp(-((cx - cx0) ** 2 + (cy - cy0) ** 2)
                            / (2 * sigma * sigma))
        score = area * centrality
        if score > best_score:
            best_score, best = score, comp
    if best is None:
        return None
    # box = spatial extent of the winning component's (tight) mask pixels,
    # robust-trimmed. Saliency-WEIGHTED quantiles collapse toward the
    # highest-contrast features (eyes/mouth) and under-cover low-contrast
    # face edges; unweighted coordinate quantiles track the true extent.
    ys, xs = np.nonzero((labels == best) & mask)
    if mouth_w is not None:
        # clutter merged into the face component by the bridging step sits
        # far from the mouth. Keep pixels inside the face window implied by
        # 68-landmark geometry around the mouth anchor: face half-width
        # ~1.3x mouth width, face top ~2.6x above the mouth, chin ~0.7x
        # below (mouth_crop.default_mean_face proportions), padded ~20%.
        keep = (np.abs(xs - cx0) <= 1.6 * mouth_w) & \
               (ys - cy0 >= -3.1 * mouth_w) & (ys - cy0 <= 1.1 * mouth_w)
        if keep.sum() >= 0.05 * len(xs):
            xs, ys = xs[keep], ys[keep]
    elif motion_box is not None:
        # whole-face motion: keep pixels inside the padded motion outline
        mbx0, mby0, mbx1, mby1 = motion_box
        px, py = 0.08 * (mbx1 - mbx0), 0.08 * (mby1 - mby0)
        keep = (xs >= mbx0 - px) & (xs <= mbx1 + px) & \
               (ys >= mby0 - py) & (ys <= mby1 + py)
        if keep.sum() >= 0.05 * len(xs):
            xs, ys = xs[keep], ys[keep]
    x0, x1 = int(np.quantile(xs, 0.01)), int(np.quantile(xs, 0.99)) + 1
    y0, y1 = int(np.quantile(ys, 0.01)), int(np.quantile(ys, 0.99)) + 1
    if (x1 - x0) < min_rel_size * w or (y1 - y0) < min_rel_size * h:
        return None
    return (x0 + ox, y0 + oy, x1 + ox, y1 + oy)


class HeuristicLandmarks:
    """Landmark estimator that runs in this image (dlib-free raw-video path).

    Per the reference's detection policy (face_landmarks_server.py:55-347 +
    config.py:64): detect on every `nth_frame`, reuse the previous box in
    between, and re-detect inside a 1.3x window around the previous box
    (config.py:65). Additional temporal hardening beyond the reference:
      * EMA box smoothing (smooth=0.5) suppresses per-frame jitter
      * jump rejection: a fresh detection with IoU < reject_iou vs the
        smoothed track is discarded (background clutter / momentary
        mis-detections); `max_rejects` consecutive rejections force a
        full-frame re-detect so scene cuts still re-acquire
    Landmarks are the canonical 68-pt mean shape
    (mouth_crop.default_mean_face) scaled into the detected box, with the
    mouth points (48-67) re-centered on the strongest horizontal-gradient
    band in the lower half of the box (lips are the highest-contrast
    horizontal structure there).
    """

    def __init__(self, nth_frame: int = DETECTION_NTH_FRAME,
                 refine_mouth: bool = True, smooth: float = 0.5,
                 reject_iou: float = 0.15, max_rejects: int = 5,
                 detect_downscale: int = 2):
        self.nth_frame = nth_frame
        self.refine_mouth = refine_mouth
        self.smooth = smooth
        self.reject_iou = reject_iou
        self.max_rejects = max_rejects
        # detection at reduced resolution (the reference downscales to
        # <= 500 px before its CNN, face_landmarks_server.py:103-111); the
        # saliency box is coarse by construction, so half-res detection
        # costs ~4x less filtering. Shape placement + mouth refinement stay
        # at FULL resolution. 1 disables.
        self.detect_downscale = max(1, detect_downscale)

    def _place_shape(self, box, frame: np.ndarray) -> np.ndarray:
        from lip2speech_tpu_torch.pipeline.mouth_crop import default_mean_face

        canon = default_mean_face()
        cmin, cmax = canon.min(axis=0), canon.max(axis=0)
        x0, y0, x1, y1 = box
        scale = np.array([(x1 - x0) / (cmax[0] - cmin[0]),
                          (y1 - y0) / (cmax[1] - cmin[1])])
        pts = (canon - cmin) * scale + np.array([x0, y0], np.float64)
        if self.refine_mouth:
            c = self._mouth_center(frame, box)
            if c is not None:
                pts[48:68] += c - pts[48:68].mean(axis=0)
        return pts

    @staticmethod
    def _mouth_center(frame: np.ndarray, box) -> np.ndarray | None:
        g = frame.astype(np.float64)
        if g.ndim == 3:
            g = g.mean(axis=-1)
        x0, y0, x1, y1 = box
        bh, bw = y1 - y0, x1 - x0
        ry0, ry1 = y0 + int(0.55 * bh), y0 + int(0.95 * bh)
        rx0, rx1 = x0 + int(0.25 * bw), x0 + int(0.75 * bw)
        region = g[ry0:ry1, rx0:rx1]
        if region.shape[0] < 3 or region.shape[1] < 3:
            return None
        grad = np.abs(np.diff(region, axis=0))
        row_e = grad.sum(axis=1)
        if row_e.sum() <= 1e-9:
            return None
        my = ry0 + float(np.argmax(row_e)) + 0.5
        band = grad[max(0, int(np.argmax(row_e)) - 2): int(np.argmax(row_e)) + 3]
        col_e = band.sum(axis=0)
        mx = rx0 + (float((col_e * np.arange(len(col_e))).sum() / col_e.sum())
                    if col_e.sum() > 0 else 0.5 * (rx1 - rx0))
        return np.array([mx, my], np.float64)

    def _detect_once(self, small: np.ndarray, i: int, prior,
                     motion, mnoise):
        """One detection attempt on the DOWNSCALED frame sequence; `prior`
        is the current full-res track box or None. Returns a full-res box
        or None. Subclasses swap the detector; the tracking loop stays."""
        ds = self.detect_downscale
        if prior is not None and ds > 1:
            prior = tuple(v / ds for v in prior)
        det = detect_face_box(small[i], prior_box=prior,
                              motion=motion, motion_noise=mnoise,
                              px_scale=float(ds))
        if det is None and prior is None:
            # tiny-face fallback: faces <15% of the frame fail the
            # envelope's size floors outright. Retry the FULL-frame
            # detect with a relaxed floor — tracked re-detects keep
            # the strict floor, so clutter rejection is unchanged
            # whenever a face was ever found at the tuned scale.
            det = detect_face_box(small[i], prior_box=None,
                                  motion=motion, motion_noise=mnoise,
                                  px_scale=float(ds),
                                  min_rel_size=0.06)
        if det is not None and ds > 1:
            det = tuple(v * ds for v in det)
        return det

    @staticmethod
    def _motion_map(frames: np.ndarray, max_pairs: int = 20):
        """Temporal-difference energy of the clip (talking mouths move;
        static clutter doesn't). None for single-frame input."""
        if len(frames) < 2:
            return None
        from scipy.ndimage import uniform_filter

        # subsample BEFORE the float cast: casting the whole clip first
        # materializes hundreds of MB (240 x 360 x 480 x 8B) for ~20 frames
        step = max(1, (len(frames) - 1) // max_pairs)
        g = frames[::step].astype(np.float32)
        if g.ndim == 4:
            g = g.mean(axis=-1)
        d = np.abs(np.diff(g, axis=0)).mean(axis=0)
        k = max(3, min(d.shape) // 30)
        return uniform_filter(d, k)

    def __call__(self, frames: np.ndarray) -> list[np.ndarray | None]:
        out: list[np.ndarray | None] = []
        box = None          # smoothed track
        rejects = 0
        ds = self.detect_downscale
        frames = np.asarray(frames)
        small = frames[:, ::ds, ::ds] if ds > 1 else frames
        motion = self._motion_map(small)
        mnoise = float(np.median(motion)) if motion is not None else None
        for i, frame in enumerate(frames):
            if i % self.nth_frame == 0 or box is None:
                # track locally around the current box; full-frame when lost
                # or after too many rejected jumps (scene cut)
                prior = None if (box is None or rejects >= self.max_rejects) \
                    else box
                det = self._detect_once(small, i, prior, motion, mnoise)
                if det is not None:
                    plausible = True
                    if box is not None and rejects < self.max_rejects:
                        # faces don't change scale 2x between detections:
                        # reject implausible shrink/grow as low-confidence
                        a_det = (det[2] - det[0]) * (det[3] - det[1])
                        a_trk = (box[2] - box[0]) * (box[3] - box[1])
                        plausible = 0.5 * a_trk <= a_det <= 2.0 * a_trk
                    if not plausible:
                        rejects += 1
                    elif box is None or box_iou(det, box) >= self.reject_iou \
                            or rejects >= self.max_rejects:
                        a = self.smooth if box is not None else 1.0
                        box = tuple(
                            int(round(a * d + (1 - a) * b))
                            for d, b in zip(det, box or det))
                        rejects = 0
                    else:
                        rejects += 1
            out.append(None if box is None else self._place_shape(box, frame))
        return out


class CascadeLandmarks(HeuristicLandmarks):
    """Haar-cascade-backed landmarks: a TRAINED face detector for the raw-
    video path (reference `face_landmarks_server.py:55-347` uses a dlib CNN;
    this image ships OpenCV's trained cascade XMLs but no objdetect module,
    so detection runs on the in-tree evaluator `pipeline/haar.py`).

    Reuses HeuristicLandmarks' tracking loop (nth-frame detection, EMA
    smoothing, jump/scale rejection) and mean-shape placement; swaps the
    saliency detector for frontal+profile cascades and makes the mouth
    refinement pose-aware:
      * profile hits reveal the facing direction, which shifts the mouth
        search window toward the facing side (a profile mouth sits at
        ~0.05-0.55 of the box width, not centered);
      * the mouth row is scored by gradient x darkness — the lip seam is
        the darkest high-gradient horizontal structure; pure gradient
        locks onto the nostril shadow on real faces;
      * cascade hits are geometry-calibrated: the alt2 window is ~10%
        wider per side than the true face extent and stops above the chin
        (constant window-vs-face offsets, measured on the synthetic bench
        and stable across scenarios), so the box is inset horizontally and
        extended at the bottom before mean-shape placement.
    Falls back to the heuristic detector when no cascade fires, so DETECTION
    COVERAGE never drops below HeuristicLandmarks' synthetic-bench floor.
    (Box/crop accuracy is quantified separately for both providers in
    tests/landmark_bench.py + QUALITY.md — the cascade wins on real faces,
    the heuristic on the synthetic envelope's cartoon faces, which are out
    of the cascades' training distribution.)
    """

    _POSE_XR = {"frontal": (0.25, 0.75), "left": (0.05, 0.55),
                "right": (0.45, 0.95)}
    # cascade-window -> face-box calibration (fractions of window size):
    # x inset per side, top offset, bottom extension
    _CAL_X, _CAL_TOP, _CAL_BOT = 0.09, 0.0, 0.05

    def __init__(self, nth_frame: int = 10, min_neighbors: int = 1,
                 scale_factor: float = 1.1, **kw):
        from lip2speech_tpu_torch.pipeline.haar import CascadeFaceDetector

        super().__init__(nth_frame=nth_frame, **kw)
        # min_neighbors=1 under OpenCV groupThreshold semantics = 2 raw
        # hits per cluster (the pre-r5 effective behavior)
        self._det = CascadeFaceDetector(min_neighbors=min_neighbors,
                                        scale_factor=scale_factor)
        self._pose = "frontal"

    def __call__(self, frames: np.ndarray) -> list[np.ndarray | None]:
        # per-clip tracking state; reset so a reused provider instance
        # cannot leak the previous clip's facing direction / track
        self._pose = "frontal"
        self._misses = 0
        self._cascade_locked = False
        self._mouth_track = None
        return super().__call__(frames)

    @staticmethod
    def available() -> bool:
        from lip2speech_tpu_torch.pipeline.haar import CascadeFaceDetector
        return CascadeFaceDetector.available()

    def _detect_once(self, small: np.ndarray, i: int, prior,
                     motion, mnoise):
        ds = self.detect_downscale
        g = small[i]
        h, w = g.shape[:2]
        box = pose = None
        if prior is not None:
            # tracked re-detect inside the 1.3x prior window (the
            # reference's own policy), at ~the prior's scale — this is the
            # common case and is ~10x cheaper than a full-frame sweep
            px0, py0, px1, py1 = (v / ds for v in prior)
            mx = 0.5 * (PRE_CROP_SCALE - 1.0)
            pw, ph = px1 - px0, py1 - py0
            x0 = max(0, int(px0 - mx * pw))
            y0 = max(0, int(py0 - mx * ph))
            x1 = min(w, int(px1 + mx * pw))
            y1 = min(h, int(py1 + mx * ph))
            if x1 - x0 >= 24 and y1 - y0 >= 24:
                res = self._det(g[y0:y1, x0:x1], return_pose=True,
                                min_size=max(24, int(0.6 * min(pw, ph))))
                if res[0] is not None:
                    bx0, by0, bx1, by1 = res[0]
                    box = (bx0 + x0, by0 + y0, bx1 + x0, by1 + y0)
                    pose = res[1]
        if box is None and (prior is None or i == 0
                            or self._misses >= 2):
            # full-frame cascade sweep: at clip start, when the track is
            # lost, or after repeated tracked-window misses (the window may
            # have drifted off the face)
            box, pose = self._det(
                g, min_size=max(24, int(0.15 * min(h, w))),
                return_pose=True)
            if box is None:
                box, pose = self._det(g, min_size=24, return_pose=True)
        if box is None and prior is None and i == 0 and len(small) > 1:
            # seed scan: the cascades are pose-sensitive and the first frame
            # may catch a bad pose (blink/extreme turn). Scan forward for
            # the first hit and seed the track with it — faces move little
            # across a second, and the EMA track corrects from there on.
            for j in range(2, min(len(small), 26), 4):
                box, pose = self._det(
                    small[j], min_size=max(24, int(0.15 * min(h, w))),
                    return_pose=True)
                if box is not None:
                    break
        if box is not None:
            self._pose = pose
            self._misses = 0
            self._cascade_locked = True
            x0, y0, x1, y1 = (v * ds for v in box)
            bw, bh = x1 - x0, y1 - y0
            return (x0 + self._CAL_X * bw, y0 + self._CAL_TOP * bh,
                    x1 - self._CAL_X * bw, y1 + self._CAL_BOT * bh)
        self._misses += 1
        if self._cascade_locked:
            # the cascade HAS acquired this clip's face: coast on the
            # existing track instead of falling back — the heuristic's
            # saliency box has different geometry (it includes hair/neck),
            # and EMA-merging it into a cascade track drags the box tall
            # and pushes the mouth window onto the jaw (measured on
            # example.mp4: y1 drifted 150 -> 218 over 132 frames pre-fix)
            return None
        # cascade never fired for this clip: heuristic saliency fallback
        # keeps the synthetic-envelope coverage (cartoon/synthetic faces
        # are out of the cascades' training distribution). The heuristic
        # has no pose notion — reset so _mouth_center doesn't search a
        # stale profile window on what is now an unknown-pose box.
        self._pose = "frontal"
        return super()._detect_once(small, i, prior, motion, mnoise)

    def _mouth_center(self, frame: np.ndarray, box) -> np.ndarray | None:
        """Per-frame refinement + a temporal EMA track: a talking mouth
        moves a few px/frame, so a refined center jumping >30% of the box
        width is a mis-lock (jaw shadow, nostril) — coast on the track
        instead of following it (measured on example.mp4: per-frame
        refinement alone slips to the jawline when the box bottom sits
        near the neck)."""
        raw = self._mouth_center_raw(frame, box)
        track = getattr(self, "_mouth_track", None)
        if raw is None:
            return track
        bw = box[2] - box[0]
        if track is not None and np.hypot(*(raw - track)) > 0.3 * bw:
            return track
        self._mouth_track = (raw if track is None
                             else 0.5 * raw + 0.5 * track)
        return self._mouth_track

    def _mouth_center_raw(self, frame: np.ndarray, box) -> np.ndarray | None:
        g = frame.astype(np.float64)
        if g.ndim == 3:
            g = g.mean(axis=-1)
        x0, y0, x1, y1 = box
        bh, bw = y1 - y0, x1 - x0
        xr = self._POSE_XR[self._pose]
        ry0, ry1 = y0 + int(0.55 * bh), y0 + int(0.95 * bh)
        rx0, rx1 = x0 + int(xr[0] * bw), x0 + int(xr[1] * bw)
        ry0, rx0 = max(0, ry0), max(0, rx0)
        region = g[ry0:ry1, rx0:rx1]
        if region.shape[0] < 4 or region.shape[1] < 3:
            return None
        grad = np.abs(np.diff(region, axis=0))
        rowmean = region[:-1].mean(axis=1)
        med = float(np.median(rowmean))
        dark = np.clip((med - rowmean) / max(med, 1e-6), 0.0, None)
        score = grad.sum(axis=1) * (1.0 + 3.0 * dark)
        if score.sum() <= 1e-9:
            return None
        iy = int(np.argmax(score))
        my = ry0 + iy + 0.5
        band = grad[max(0, iy - 2): iy + 3]
        col_e = band.sum(axis=0)
        mx = rx0 + (float((col_e * np.arange(len(col_e))).sum() / col_e.sum())
                    if col_e.sum() > 0 else 0.5 * (rx1 - rx0))
        return np.array([mx, my], np.float64)


def default_landmarker() -> "LandmarkProvider":
    """The raw-video landmark provider for serving/dataset paths: the
    TRAINED cascade detector when its XMLs are shipped (real faces — the
    reference's own raw path runs a trained dlib CNN,
    face_landmarks_server.py:55-347), falling back to the heuristic
    detector. On a real talking-head clip the cascade keeps the mouth ROI
    on the lips where the heuristic's saliency box takes in the neck
    (QUALITY.md real-video table). A trained ERT shape-predictor model
    (the JAX package's cli/shape_predictor.py train) refines the layout inside the detected
    box when LIP2SPEECH_ERT_PREDICTOR points at its .npz — the reference's
    custom-predictor switch (face_landmarks_server.py)."""
    import os

    base = (CascadeLandmarks() if CascadeLandmarks.available()
            else HeuristicLandmarks())
    ert_path = os.environ.get("LIP2SPEECH_ERT_PREDICTOR")
    if ert_path and Path(ert_path).exists():
        return ErtLandmarks(ert_path, box_provider=base)
    return base


def extract_mouth_video(frames: np.ndarray, provider: LandmarkProvider,
                        mean_face: np.ndarray | None = None) -> np.ndarray:
    """frames + provider -> (T, 96, 96) mouth ROI; drops nothing (undetected
    frames are interpolated like the reference preparation pipeline)."""
    from lip2speech_tpu_torch.pipeline.mouth_crop import (
        crop_mouth_sequence, default_mean_face)

    landmarks = provider(frames)
    return crop_mouth_sequence(
        frames, landmarks,
        mean_face if mean_face is not None else default_mean_face())
