"""The port's copies of the host modules of the serving process (pipeline/
mouth_crop.py, haar.py, ert.py, landmarks.py, db.py, utils/email_client.py,
eval/asr.py) against the JAX package's, bit for bit on synthetic frames, and
the device warp (ops/warp.py) against the JAX warp on the CPU."""

import pickle
import smtplib

import numpy as np
import pytest
import torch

from lip2speech_tpu.cli.shape_predictor import pad_inner_to_68 as jax_pad_inner_to_68
from lip2speech_tpu.eval import asr as jasr
from lip2speech_tpu.ops import warp as jwarp
from lip2speech_tpu.pipeline import db as jdb
from lip2speech_tpu.pipeline import ert as jert
from lip2speech_tpu.pipeline import haar as jhaar
from lip2speech_tpu.pipeline import landmarks as jlm
from lip2speech_tpu.pipeline import mouth_crop as jmc
from lip2speech_tpu.utils import email_client as jemail
from lip2speech_tpu_torch.eval import asr as tasr
from lip2speech_tpu_torch.ops import warp as twarp
from lip2speech_tpu_torch.pipeline import db as tdb
from lip2speech_tpu_torch.pipeline import ert as tert
from lip2speech_tpu_torch.pipeline import haar as thaar
from lip2speech_tpu_torch.pipeline import landmarks as tlm
from lip2speech_tpu_torch.pipeline import mouth_crop as tmc
from lip2speech_tpu_torch.utils import email_client as temail

from landmark_bench import render_video


@pytest.fixture(scope="module")
def clip():
    """8 frames of a talking cartoon face (240 x 320), its ground-truth
    landmarks, and the heuristic detector's landmarks."""
    frames, _boxes, _mouths, lms = render_video(t=8, seed=3, jitter=1.0, return_landmarks=True)
    return frames, lms


def _equal_landmarks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_mouth_crop_matches_jax(clip):
    frames, lms = clip
    mean = tmc.default_mean_face()
    np.testing.assert_array_equal(mean, jmc.default_mean_face())
    m = tmc.estimate_similarity(lms[0][list(tmc.STABLE_POINTS)], mean[list(tmc.STABLE_POINTS)])
    np.testing.assert_array_equal(m, jmc.estimate_similarity(
        lms[0][list(jmc.STABLE_POINTS)], mean[list(jmc.STABLE_POINTS)]))
    np.testing.assert_array_equal(tmc.warp_image(frames[0], m), jmc.warp_image(frames[0], m))
    holes = [None, lms[1], None, None, lms[4], None, lms[6], None]
    _equal_landmarks(tmc.interpolate_landmarks(holes), jmc.interpolate_landmarks(holes))
    got = tmc.crop_mouth_sequence(frames, holes, mean)
    np.testing.assert_array_equal(got, jmc.crop_mouth_sequence(frames, holes, mean))
    assert got.shape == (8, 96, 96) and got.dtype == np.uint8
    canvas = np.arange(256 * 256, dtype=np.float64).reshape(256, 256)
    for centre in ([[300.0, 20.0]], [[128.4, 127.6]]):        # clamped, then inside
        np.testing.assert_array_equal(tmc.cut_patch(canvas, np.array(centre), 48, 48),
                                      jmc.cut_patch(canvas, np.array(centre), 48, 48))


def test_haar_detector_matches_jax(clip):
    frames, _ = clip
    assert thaar.HAAR_DIRS == jhaar.HAAR_DIRS
    assert thaar.CascadeFaceDetector.available() == jhaar.CascadeFaceDetector.available()
    if not jhaar.CascadeFaceDetector.available():
        pytest.skip("no OpenCV cascade XMLs installed (HAAR_DIRS)")
    ours, theirs = thaar.CascadeFaceDetector(), jhaar.CascadeFaceDetector()
    for g in (frames[0, ::2, ::2], np.full((120, 160), 128, np.uint8)):
        assert ours(g, return_pose=True) == theirs(g, return_pose=True)
    boxes = [(0, 0, 40, 40, 1), (2, 1, 41, 42, 1), (100, 80, 130, 110, 1)]
    assert thaar.group_boxes(boxes, 1) == jhaar.group_boxes(boxes, 1)


def _ert_model(path, n_points=41, seed=0):
    """A random 3-level cascade in the JAX package's .npz layout."""
    rng = np.random.default_rng(seed)
    depth, trees, pool = 3, 6, 40
    levels = [{"anchors": rng.integers(0, n_points, pool),
               "deltas": rng.normal(0, 0.05, (pool, 2)),
               "split_pix": rng.integers(0, pool, (trees, 2 ** depth - 1, 2)),
               "split_thr": rng.normal(0, 20, (trees, 2 ** depth - 1)),
               "leaves": rng.normal(0, 0.01, (trees, 2 ** depth, n_points, 2))}
              for _ in range(3)]
    jert.ErtModel(rng.uniform(0.2, 0.8, (n_points, 2)), levels, depth).save(path)
    return path


def test_ert_model_matches_jax(tmp_path, clip):
    frames, _ = clip
    path = _ert_model(tmp_path / "ert.npz")
    ours, theirs = tert.ErtModel.load(path), jert.ErtModel.load(path)
    boxes = [(100.0, 50.0, 220.0, 190.0), (90.5, 40.0, 230.0, 200.5)]
    got = ours.predict_batch(list(frames[:2]), boxes)
    for g, r in zip(got, theirs.predict_batch(list(frames[:2]), boxes)):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tert.pad_inner_to_68(got[0]), jax_pad_inner_to_68(got[0]))


@pytest.mark.parametrize("provider", ["heuristic", "cascade", "ert", "default", "precomputed",
                                      "precomputed_pkl"])
def test_landmark_providers_match_jax(provider, clip, tmp_path, monkeypatch):
    frames, lms = clip
    if provider in ("cascade", "ert") and not jlm.CascadeLandmarks.available():
        pytest.skip("no OpenCV cascade XMLs installed (HAAR_DIRS)")
    if provider == "heuristic":
        ours, theirs = tlm.HeuristicLandmarks(), jlm.HeuristicLandmarks()
    elif provider == "cascade":
        ours, theirs = tlm.CascadeLandmarks(), jlm.CascadeLandmarks()
    elif provider == "ert":
        path = _ert_model(tmp_path / "ert.npz")
        ours = tlm.ErtLandmarks(str(path), box_provider=tlm.HeuristicLandmarks())
        theirs = jlm.ErtLandmarks(str(path), box_provider=jlm.HeuristicLandmarks())
    elif provider == "default":
        monkeypatch.setenv("LIP2SPEECH_ERT_PREDICTOR", str(_ert_model(tmp_path / "e.npz")))
        ours, theirs = tlm.default_landmarker(), jlm.default_landmarker()
        assert type(ours).__name__ == type(theirs).__name__ == "ErtLandmarks"
        assert type(ours.box_provider).__name__ == type(theirs.box_provider).__name__
    else:
        path = tmp_path / ("lms.npy" if provider == "precomputed" else "lms.pkl")
        rows = [None if i == 3 else lm for i, lm in enumerate(lms)]
        if provider == "precomputed":
            np.save(path, np.array(rows, dtype=object), allow_pickle=True)
        else:
            path.write_bytes(pickle.dumps(rows))
        ours, theirs = tlm.PrecomputedLandmarks(path), jlm.PrecomputedLandmarks(path)
    got = ours(frames)
    _equal_landmarks(got, theirs(frames))
    assert sum(lm is not None for lm in got) >= 6
    crop = tlm.extract_mouth_video(frames, lambda f: got)    # a cascade sweep is ~1.6 s
    np.testing.assert_array_equal(crop, jlm.extract_mouth_video(frames, lambda f: got))
    assert crop.shape == (8, 96, 96)


def test_face_box_helpers_and_dlib_gate(clip):
    frames, _ = clip
    assert tlm.detect_face_box(frames[0]) == jlm.detect_face_box(frames[0])
    assert tlm.detect_face_box(np.full((240, 320), 90, np.uint8)) is None
    a, b = (0, 0, 10, 10), (5, 5, 15, 15)
    assert tlm.box_iou(a, b) == jlm.box_iou(a, b) and tlm.box_iou(None, b) == 0.0
    with pytest.raises(ImportError):            # no dlib: raises on construction, as in JAX
        tlm.DlibLandmarks("predictor.dat")
    with pytest.raises(ValueError, match="landmark rows"):
        tlm.PrecomputedLandmarks.__call__(type("P", (), {"load": lambda self: [None]})(), frames)


def _warp_f64(frames, mats, centers, crop=96):
    """warp_crop_batch's math in float64 numpy (inverse of the f32
    matrices, bilinear, zeros outside): the exact answer both f32 warps
    approximate."""
    t, h, w = frames.shape
    g = np.arange(crop, dtype=np.float64)
    cx = np.round(centers[:, 0].astype(np.float64))[:, None, None] - crop // 2 + g[None, None, :]
    cy = np.round(centers[:, 1].astype(np.float64))[:, None, None] - crop // 2 + g[None, :, None]
    inv = np.linalg.inv(mats.astype(np.float64))[:, :2, :, None, None]
    xs = inv[:, 0, 0] * cx + inv[:, 0, 1] * cy + inv[:, 0, 2]
    ys = inv[:, 1, 0] * cx + inv[:, 1, 1] * cy + inv[:, 1, 2]
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    fx, fy = xs - x0, ys - y0
    f = np.arange(t)[:, None, None]

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(ok, frames[f, yy.clip(0, h - 1), xx.clip(0, w - 1)], 0.0)

    return ((1 - fx) * (1 - fy) * at(y0, x0) + fx * (1 - fy) * at(y0, x0 + 1)
            + (1 - fx) * fy * at(y0 + 1, x0) + fx * fy * at(y0 + 1, x0 + 1))


def test_warp_crop_batch_matches_jax(clip):
    """The device warp on the CPU against the exact (float64) warp within
    1e-5 of max |ref|, and against the JAX warp within 2e-5: the port's f32
    3x3 inverse is rounded to nearest (7.7e-7 off the exact one on this
    clip) where JAX's LU is 1.5e-6 off, and at the cartoon face's step edges
    (70 levels a pixel) that reads 1.2e-5 of max |ref| between the two. The
    uint8 crops are at most 1 level apart (a truncation at an integer) and,
    through crop_mouth_sequence_device, at most 2 from the host crop (which
    rounds to uint8 before cropping)."""
    frames, lms = clip
    mean = tmc.default_mean_face()
    rng = np.random.default_rng(1)
    mats = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    mats[:, :2, :2] *= rng.uniform(0.8, 1.6, (8, 1, 1)).astype(np.float32)
    mats[:, :2, 2] = rng.uniform(-40, 40, (8, 2))
    centers = rng.uniform(48, 208, (8, 2)).astype(np.float32)
    ref = np.asarray(jwarp.warp_crop_batch(frames.astype(np.float32), mats, centers))
    exact = _warp_f64(frames.astype(np.float64), mats, centers)
    got = twarp.warp_crop_batch(*(torch.from_numpy(np.asarray(a, np.float32))
                                  for a in (frames, mats, centers))).numpy()
    assert got.shape == ref.shape == (8, 96, 96)
    np.testing.assert_allclose(got, exact, atol=1e-5 * np.abs(exact).max(), rtol=0)
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)
    dev = twarp.crop_mouth_sequence_device(frames, lms, mean, device="cpu")
    jdev = jwarp.crop_mouth_sequence_device(frames.astype(np.float32), lms, mean)
    assert np.abs(dev.astype(int) - jdev.astype(int)).max() <= 1
    host = tmc.crop_mouth_sequence(frames, lms, mean)
    assert np.abs(dev.astype(int) - host.astype(int)).max() <= 2


def test_db_email_and_asr_match_jax(tmp_path, monkeypatch):
    ours, theirs = tdb.DB(tmp_path / "a.db"), jdb.DB(tmp_path / "b.db")
    def tables(d):
        with d.connect() as conn:
            return conn.execute("SELECT name, sql FROM sqlite_master ORDER BY name").fetchall()

    assert tables(ours) == tables(theirs)
    for d in (ours, theirs, tdb.DB(":memory:")):
        d.log_usage(1.5, 0.2, audio_name="alice", transcription="hi")
        d.log_vsg_usage(30.0, "a@b.c")
        assert d.usage_count() == 1
    sent = []

    class FakeSMTP:
        def __init__(self, host, port):
            sent.append((host, port))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def starttls(self):
            pass

        def login(self, user, password):
            sent.append(user)

        def sendmail(self, sender, receivers, msg):
            sent.append((sender, receivers, msg.split("\n\n", 1)[1]))

    monkeypatch.setattr(smtplib, "SMTP", FakeSMTP)
    for send in (temail.send_email, jemail.send_email):
        assert send("s", "b") is False                        # no credentials
        assert send("s", "body", ["x@y.z"], host="h", username="u", password="p") is True
    assert sent[:len(sent) // 2] == sent[len(sent) // 2:]
    assert tasr.try_load_asr(None) is None is jasr.try_load_asr(None)

    def no_weights(*args, **kwargs):
        raise OSError("no Whisper weights")

    monkeypatch.setattr(tasr, "WhisperASR", no_weights)    # transformers takes ~10 s to import
    assert tasr.try_load_asr(str(tmp_path / "no_whisper"), device="cpu") is None
