"""The port's host media helpers (lip2speech_tpu_torch/pipeline/media.py) and
its libav shims (native/media_{demux,mux}.c) against the JAX package's on
the same inputs: the ffmpeg argv builders bit for bit, the cv2 transcodes on
videos written with cv2 (frames and props equal), the audio pad ops (equal
files), the probe helpers without ffprobe, the shims (a mux then a decode;
equal samples), the raise of a shim that does not build and the None of
extract_audio without a backend, and the two departures from the JAX
module (change_fps with a container that over-reports its frames,
extract_audio to no file through ffmpeg)."""

import numpy as np
import pytest

from lip2speech_tpu import native as jnative
from lip2speech_tpu.pipeline import media as jmedia
from lip2speech_tpu_torch import native as tnative
from lip2speech_tpu_torch.pipeline import media as tmedia
from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

cv2 = pytest.importorskip("cv2")

SEGMENTS = [(0.0, 1.5, "a.mp4"), (61.25, 3725.5, "b.mp4")]

ARGV = {
    "resize_cmd": ("in.mp4", "out.mp4", 320, 240),
    "fps_cmd": ("in.mp4", "out.mp4", 30),
    "extract_audio_cmd": ("in.mp4", "out.wav", 22_050),
    "concat_cmd": ("list.txt", "out.mp4"),
    "pad_audio_start_cmd": ("in.wav", "out.wav", 3),
    "pad_audio_end_cmd": ("in.wav", "out.wav", 1.5),
    "remove_audio_pad_cmd": ("in.wav", "out.wav", 7),
    "crop_video_cmd": ("in.mp4", "out.mp4", 3.25, 3671.125),
    "crop_video_multiple_cmd": ("in.mp4", SEGMENTS),
    "speed_cmd": ("in.mp4", "out.mp4", 1.25),
    "normalize_audio_cmd": ("in.wav", "out.wav", 16_000),
    "_ffmpeg_time": (3725.5,),
    "get_updated_dims": (1920, 1080),
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_argv_builders_match_jax(name):
    """Every ffmpeg argv builder (and the time / dims helpers): equal."""
    args = ARGV[name]
    assert getattr(tmedia, name)(*args) == getattr(jmedia, name)(*args)


def _write_video(path, n=20, fps=25.0, w=64, h=48, seed=0):
    """An mp4v clip of n frames with content that varies across the frame
    and in time."""
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for i in range(n):
        writer.write(np.roll(base, 3 * i, axis=1))
    writer.release()
    return path


def _frames(path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    out = []
    ok, f = cap.read()
    while ok:
        out.append(f)
        ok, f = cap.read()
    cap.release()
    return np.stack(out)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("media")
    return {"a": _write_video(tmp / "a.mp4"), "b": _write_video(tmp / "b.mp4", n=12, seed=1)}


@pytest.mark.parametrize("op", ["resize", "fps_up", "fps_down", "crop", "concat", "props"])
def test_cv2_paths_match_jax(op, clips, tmp_path):
    """The in-process transcodes (no ffmpeg binary here): equal results,
    frames equal bit for bit, equal video_props."""
    a, b = clips["a"], clips["b"]
    calls = {"resize": lambda m, dst: m.resize_video(a, dst, 32, 24),
             "fps_up": lambda m, dst: m.change_fps(a, dst, 30),
             "fps_down": lambda m, dst: m.change_fps(a, dst, 10),
             "crop": lambda m, dst: m.crop_video(a, dst, 0.2, 0.6),
             "concat": lambda m, dst: m.concat_videos([a, b], dst)}
    if op == "props":
        assert tmedia.video_props(a) == jmedia.video_props(a)
        assert tmedia.video_props(tmp_path / "missing.mp4") is jmedia.video_props(
            tmp_path / "missing.mp4") is None
        return
    assert not tmedia.ffmpeg_available()
    got, ref = tmp_path / "port.mp4", tmp_path / "jax.mp4"
    assert calls[op](tmedia, got) is calls[op](jmedia, ref) is True
    np.testing.assert_array_equal(_frames(got), _frames(ref))
    assert tmedia.video_props(got) == jmedia.video_props(ref)


def test_probe_helpers_without_ffprobe_match_jax(clips):
    a = clips["a"]
    assert tmedia.probe(a) == jmedia.probe(a) == {}
    for name in ("get_fps", "get_duration_s", "is_valid_video_format"):
        assert getattr(tmedia, name)(a) is getattr(jmedia, name)(a) is None


@pytest.mark.parametrize("op,arg", [("pad_audio_start", 0.25), ("pad_audio_end", 0.5),
                                    ("remove_audio_pad", 0.125)])
def test_audio_pad_ops_match_jax(op, arg, tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "in.wav"
    write_wav(src, 0.5 * rng.standard_normal(8_000), 16_000)
    assert getattr(tmedia, op)(src, tmp_path / "port.wav", arg)
    assert getattr(jmedia, op)(src, tmp_path / "jax.wav", arg)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_shims_mux_and_decode_like_jax(clips, tmp_path):
    """The port's libav shims (built here with cc; the system libav): the
    listening-copy mux of a sine over a cv2 clip, then its decode and probe,
    against the JAX shims on the JAX mux's file: equal samples, equal rate,
    and both muxed files decode alike."""
    if jnative._lib("media_mux", jnative._cfg_media_mux) is None:
        pytest.skip("the JAX shims do not build here")
    t = np.arange(16_000) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    assert tnative.mux_overlay(clips["a"], audio, 16_000, tmp_path / "port.mp4")
    assert jnative.mux_overlay(clips["a"], audio, 16_000, tmp_path / "jax.mp4")
    for f in ("port.mp4", "jax.mp4"):
        got = tnative.decode_audio(tmp_path / f, 16_000)
        ref = jnative.decode_audio(tmp_path / f, 16_000)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.float32 and len(got) > 8_000
        assert tnative.probe_audio_sample_rate(tmp_path / f) == jnative.probe_audio_sample_rate(
            tmp_path / f) > 0
        assert tmedia.has_audio_stream(tmp_path / f) is jmedia.has_audio_stream(tmp_path / f)
        np.testing.assert_array_equal(tmedia.extract_audio(tmp_path / f),
                                      jmedia.extract_audio(tmp_path / f))
    np.testing.assert_array_equal(tnative.decode_audio(tmp_path / "port.mp4"),
                                  tnative.decode_audio(tmp_path / "jax.mp4"))
    # a video without audio: 0 from the probe, ValueError from the decode
    assert tnative.probe_audio_sample_rate(clips["a"]) == 0
    assert tmedia.has_audio_stream(clips["a"]) is jmedia.has_audio_stream(clips["a"]) is False
    with pytest.raises(ValueError, match="no audio stream"):
        tnative.decode_audio(clips["a"])


@pytest.fixture
def no_shims(tmp_path, monkeypatch):
    """The port's shims as on a machine without libav headers (their sources
    include a header that is not there, so cc fails); the JAX shims as the
    JAX loader leaves them when they do not build (None)."""
    src = tmp_path / "src"
    src.mkdir()
    for stem in ("media_demux", "media_mux"):
        (src / f"{stem}.c").write_text("#include <libavformat/not_installed.h>\n")
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIBS", {})
    monkeypatch.setattr(jnative, "_lib", lambda stem, configure: None)


def test_a_shim_that_does_not_build_raises(no_shims, clips, tmp_path):
    for call in (lambda: tnative.decode_audio(clips["a"]),
                 lambda: tnative.probe_audio_sample_rate(clips["a"]),
                 lambda: tnative.mux_overlay(clips["a"], np.zeros(160, np.float32), 16_000,
                                             tmp_path / "out.mp4")):
        with pytest.raises(tnative.BuildError, match="cc exited"):
            call()


def test_extract_audio_without_a_backend_matches_jax(no_shims, clips, tmp_path):
    """No shim and no ffmpeg: extract_audio None (with or without dst),
    has_audio_stream None, as the JAX module."""
    a = clips["a"]
    for dst in (None, tmp_path / "a.wav"):
        assert tmedia.extract_audio(a, dst) is jmedia.extract_audio(a, dst) is None
    assert not (tmp_path / "a.wav").exists()
    assert tmedia.has_audio_stream(a) is jmedia.has_audio_stream(a) is None


def test_change_fps_plans_over_the_frames_that_decode(clips, tmp_path, monkeypatch):
    """A container that reports 8 frames more than decode (a departure, ROADMAP
    §3 item 10): the JAX change_fps indexes a frame it never read
    (KeyError); the port's resamples the 20 frames that decode, as for an
    honest count."""
    a = clips["a"]
    real = tmedia.video_props(a)
    over = dict(real, frame_count=real["frame_count"] + 8)
    monkeypatch.setattr(jmedia, "video_props", lambda path: dict(over))
    with pytest.raises(KeyError):
        jmedia.change_fps(a, tmp_path / "jax.mp4", 30)
    honest = tmp_path / "honest.mp4"
    assert tmedia.change_fps(a, honest, 30)
    monkeypatch.setattr(tmedia, "video_props", lambda path: dict(over))
    got = tmp_path / "port.mp4"
    assert tmedia.change_fps(a, got, 30)
    np.testing.assert_array_equal(_frames(got), _frames(honest))
    assert len(_frames(got)) == round(20 * 30 / 25)


def test_extract_audio_to_no_file_falls_back_to_ffmpeg(no_shims, clips, tmp_path, monkeypatch):
    """No shim, an ffmpeg binary (faked: it writes a known wav where the argv
    says), dst None (a departure, ROADMAP §3 item 10): the JAX
    extract_audio returns None without calling ffmpeg; the port's runs it
    into a temporary wav and returns its samples. With a dst both return
    the same samples."""
    t = np.arange(4_000) / 16_000
    wav = (0.25 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    calls = []

    def fake_run(cmd):
        calls.append(cmd)
        write_wav(cmd[-1], wav, 16_000)
        return True

    for m in (tmedia, jmedia):
        monkeypatch.setattr(m, "ffmpeg_available", lambda: True)
        monkeypatch.setattr(m, "run", fake_run)
    assert jmedia.extract_audio(clips["a"]) is None and not calls
    got = tmedia.extract_audio(clips["a"])
    assert len(calls) == 1 and calls[0][:-1] == tmedia.extract_audio_cmd(clips["a"], "x")[:-1]
    ref = read_wav_samples(tmp_path, wav)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tmedia.extract_audio(clips["a"], tmp_path / "p.wav"),
                                  jmedia.extract_audio(clips["a"], tmp_path / "j.wav"))


def read_wav_samples(tmp_path, wav) -> np.ndarray:
    """`wav` as it reads back from a 16-bit file."""
    write_wav(tmp_path / "ref.wav", wav, 16_000)
    return read_wav(tmp_path / "ref.wav")[0]
