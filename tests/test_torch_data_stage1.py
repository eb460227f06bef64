"""The port's host data path (lip2speech_tpu_torch/data: video_io,
transforms, manifest, stage1, prefetch) against the JAX package's on the
same files and seeds: stage-1 batches equal bit for bit (train with random
erase and time mask, eval, the uint8 wire format, by-frame-count batching),
each transform's output and its draws from the generator, video loading
from .npy and .gray, the unit-token maps, and the prefetcher's order, errors
and close()."""

import threading
import time

import numpy as np
import pytest

from lip2speech_tpu.data import manifest as jmanifest
from lip2speech_tpu.data import stage1 as jstage1
from lip2speech_tpu.data import transforms as jtf
from lip2speech_tpu.data import video_io as jvio
from lip2speech_tpu_torch.data import manifest as tmanifest
from lip2speech_tpu_torch.data import prefetch as tprefetch
from lip2speech_tpu_torch.data import stage1 as tstage1
from lip2speech_tpu_torch.data import transforms as ttf
from lip2speech_tpu_torch.data import video_io as tvio
from lip2speech_tpu_torch.utils.audio_io import write_wav

LENS = (12, 30, 45, 50, 70, 100, 20, 130)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """8 clips across three buckets, written with the port's writers: .npy
    videos (96x96 uint8), wavs, speaker embeddings, mels, .tsv, .unt and
    dict.unt.txt."""
    root = tmp_path_factory.mktemp("s1data")
    rng = np.random.default_rng(0)
    utts, rows = [], []
    for i, n in enumerate(LENS):
        uid = f"spk{i % 3}/clip{i}"
        tvio.save_video_gray(root / "video" / f"{uid}.mp4",
                             rng.integers(0, 256, (n, 96, 96), dtype=np.uint8))
        write_wav(root / "audio" / f"{uid}.wav", 0.1 * rng.standard_normal(n * 640), 16_000)
        for sub, arr in (("spk_emb", rng.standard_normal(256)),
                         ("mel", rng.standard_normal((4 * n + 1, 80)))):
            (root / sub / f"spk{i % 3}").mkdir(parents=True, exist_ok=True)
            np.save(root / sub / f"{uid}.npy", arr.astype(np.float32))
        utts.append(tmanifest.Utterance(uid, root / "video" / f"{uid}.mp4",
                                        root / "audio" / f"{uid}.wav", n, n * 640))
        rows.append(rng.integers(0, 200, 2 * n + int(rng.integers(-2, 3))))
    tmanifest.write_manifest(root / "label" / "train.tsv", root, utts)
    tmanifest.write_units(root / "label" / "train.unt", rows)
    tmanifest.write_unit_dictionary(root / "label" / "dict.unt.txt")
    return root / "label" / "train.tsv", root / "label" / "train.unt"


def _assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert g["ids"] == r["ids"]
        for k in r:
            if k != "ids":
                assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("kw,batching", [
    pytest.param(dict(train=True, random_erase=True, time_mask=True, seed=3),
                 dict(batch_size=3, shuffle=True), id="train-erase-mask"),
    pytest.param(dict(train=False), dict(batch_size=3), id="eval"),
    pytest.param(dict(train=True, random_erase=True, time_mask=True, seed=4, emit_uint8=True),
                 dict(batch_size=2, shuffle=True), id="train-uint8"),
    pytest.param(dict(train=False, emit_uint8=True), dict(batch_size=4), id="eval-uint8"),
    pytest.param(dict(train=True, seed=5, max_frames=60),
                 dict(frames_budget=200, shuffle=True), id="frames-budget"),
])
def test_stage1_batches_equal_jax_bitwise(dataset, kw, batching):
    """Two epochs from one dataset object each, so that the generator's
    state carries across epochs as it does in training."""
    tsv, unt = dataset
    ref = jstage1.Stage1Dataset(tsv, unt, **kw)
    got = tstage1.Stage1Dataset(tsv, unt, **kw)
    for _ in range(2):
        _assert_batches_equal(got.batches(**batching), ref.batches(**batching))


def test_stage1_batches_need_exactly_one_batching_rule(dataset):
    ds = tstage1.Stage1Dataset(*dataset)
    for kw in ({}, {"batch_size": 2, "frames_budget": 100}):
        with pytest.raises(ValueError, match="exactly one"):
            next(ds.batches(**kw))


@pytest.mark.parametrize("n", [0, 1, 47, 48, 49, 600, 601, 5000])
def test_pick_bucket_matches_jax(n):
    assert tstage1.pick_bucket(n) == jstage1.pick_bucket(n)
    assert tstage1.DEFAULT_BUCKETS == jstage1.DEFAULT_BUCKETS


@pytest.mark.parametrize("fn,args", [
    ("random_crop", (88,)), ("horizontal_flip", ()), ("random_erase", ()),
    ("time_mask", ()), ("adaptive_time_mask", ()),
])
def test_transforms_equal_jax_and_draw_alike(fn, args):
    """Each random transform on 60 frames, 20 seeds: the same output and the
    generator left in the same state (the next draw equal)."""
    frames = np.random.default_rng(1).standard_normal((60, 96, 96)).astype(np.float32)
    for seed in range(20):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(getattr(ttf, fn)(frames, *args, rt) if args else
                                      getattr(ttf, fn)(frames, rt),
                                      getattr(jtf, fn)(frames, *args, rj) if args else
                                      getattr(jtf, fn)(frames, rj))
        assert rt.random() == rj.random()


def test_center_crop_prepare_video_and_noise_mix_equal_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (30, 96, 96), dtype=np.uint8)
    np.testing.assert_array_equal(ttf.center_crop(frames, 88), jtf.center_crop(frames, 88))
    for kw in (dict(train=False), dict(train=False, emit_uint8=True)):
        np.testing.assert_array_equal(ttf.prepare_video(frames, **kw),
                                      jtf.prepare_video(frames, **kw))
    assert ttf.UINT8_FILL == jtf.UINT8_FILL == 107
    assert (ttf.IMAGE_MEAN, ttf.IMAGE_STD) == (jtf.IMAGE_MEAN, jtf.IMAGE_STD)
    wav, noise = rng.standard_normal(1000), rng.standard_normal(300)
    np.testing.assert_array_equal(ttf.mix_noise(wav, noise, 5.0, np.random.default_rng(7)),
                                  jtf.mix_noise(wav, noise, 5.0, np.random.default_rng(7)))
    with pytest.raises(ValueError, match="Generator"):
        ttf.prepare_video(frames, train=True)


def test_video_loading_npy_gray_and_rgb(tmp_path):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (5, 12, 10), dtype=np.uint8)
    tvio.save_video_gray(tmp_path / "a.mp4", frames)
    np.testing.assert_array_equal(tvio.load_video_gray(tmp_path / "a.mp4"), frames)
    header = np.array(frames.shape, "<i4").tobytes()
    (tmp_path / "b.gray").write_bytes(header + frames.tobytes())
    np.testing.assert_array_equal(tvio.load_video_gray(tmp_path / "b.gray"), frames)
    np.testing.assert_array_equal(jvio.load_video_gray(tmp_path / "b.gray"), frames)
    rgb = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    np.save(tmp_path / "c.npy", rgb)
    np.testing.assert_array_equal(tvio.load_video_gray(tmp_path / "c.mp4"),
                                  jvio.load_video_gray(tmp_path / "c.mp4"))
    np.testing.assert_array_equal(tvio.rgb_to_gray(rgb), jvio.rgb_to_gray(rgb))
    with pytest.raises(FileNotFoundError, match="no .npy sidecar"):
        tvio.load_video_gray(tmp_path / "missing.mp4")


def test_manifest_writers_and_unit_tokens_match_jax(dataset, tmp_path):
    tsv, unt = dataset
    got, ref = tmanifest.read_manifest(tsv, unt), jmanifest.read_manifest(tsv, unt)
    assert [(u.uid, u.n_frames, str(u.mel_path)) for u in got] == \
        [(u.uid, u.n_frames, str(u.mel_path)) for u in ref]
    root = tsv.parent.parent
    jmanifest.write_manifest(tmp_path / "j.tsv", root, ref)
    assert (tmp_path / "j.tsv").read_text() == tsv.read_text()
    jmanifest.write_unit_dictionary(tmp_path / "dict.txt")
    assert (tmp_path / "dict.txt").read_text() == (tsv.parent / "dict.unt.txt").read_text()
    units = np.array([0, 5, 199, 17])
    for eos in (True, False):
        toks = tmanifest.units_to_tokens(units, append_eos=eos)
        np.testing.assert_array_equal(toks, jmanifest.units_to_tokens(units, append_eos=eos))
        np.testing.assert_array_equal(tmanifest.tokens_to_units(toks), units)
    np.testing.assert_array_equal(tmanifest.tokens_to_units(np.array([0, 1, 4, 2, 203, 3])),
                                  [0, 199])


def test_prefetch_keeps_order_raises_errors_and_closes():
    assert list(tprefetch.prefetch(iter(range(50)), depth=3)) == list(range(50))

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = tprefetch.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)

    finalised = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            finalised.set()

    with tprefetch.prefetch(endless(), depth=2) as stream:
        assert [next(stream) for _ in range(5)] == list(range(5))
    assert not stream._thread.is_alive()
    assert finalised.wait(timeout=5.0)


def test_parallel_map_keeps_order_and_raises():
    def slow_square(x):
        time.sleep(0.001 * (x % 3))
        return x * x

    assert tprefetch.ParallelMap(slow_square, n_workers=4)(list(range(30))) == \
        [x * x for x in range(30)]

    def fail_on_7(x):
        if x == 7:
            raise ValueError("seven")
        return x

    with pytest.raises(ValueError, match="seven"):
        tprefetch.ParallelMap(fail_on_7, n_workers=3)(list(range(10)))
