"""The port's overlay CLI (lip2speech_tpu_torch/cli/overlay.py) against the
JAX package's, both run on the same tree of cv2-written videos, wavs (one
without a video) and landmark files: the pairing (the manifest and the
summary line), the landmark copies (equal frames), the denoised wavs (the
port's chain on --device cpu; within 1e-4 of max |ref|) and the muxed
listening copies; then both without a mux backend (the shim does not
build, no ffmpeg): nothing muxed, the same summary."""

import json
import sys

import numpy as np
import pytest

from lip2speech_tpu import native as jnative
from lip2speech_tpu.cli import overlay as joverlay
from lip2speech_tpu_torch import native as tnative
from lip2speech_tpu_torch.cli import overlay as toverlay
from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

cv2 = pytest.importorskip("cv2")

DENOISE_TOL = 1e-4      # of max |ref|, on the 16-bit files


def _tree(root):
    """videos/test/a/clip{1,2}.mp4 (10 frames, 64 x 48), wavs for both and an
    orphan, landmarks/test/a/clip1.npy (10 x 68 x 2)."""
    rng = np.random.default_rng(2)
    for i in (1, 2):
        path = root / "videos" / "test" / "a" / f"clip{i}.mp4"
        path.parent.mkdir(parents=True, exist_ok=True)
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 48))
        for _ in range(10):
            writer.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        writer.release()
    t = np.arange(6_400) / 16_000
    for name in ("clip1", "clip2", "orphan"):
        wav = 0.3 * np.sin(2 * np.pi * 200 * t) + 0.05 * rng.standard_normal(t.size)
        write_wav(root / "wavs" / "test" / "a" / f"{name}.wav", wav, 16_000)
    lm = root / "landmarks" / "test" / "a" / "clip1.npy"
    lm.parent.mkdir(parents=True)
    np.save(lm, rng.uniform(5, 40, (10, 68, 2)))


def _run_both(root, monkeypatch, capsys):
    argv = ["--video-dir", str(root / "videos"), "--pred-wav-dir", str(root / "wavs"),
            "--landmarks-dir", str(root / "landmarks"), "--denoise-and-normalise"]
    monkeypatch.setattr(sys, "argv", ["overlay", *argv, "--out-dir", str(root / "jax")])
    joverlay.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = toverlay.main([*argv, "--out-dir", str(root / "port"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    return got, ref


def _manifest(out_dir):
    return json.loads((out_dir / "overlay_manifest.json").read_text().replace(str(out_dir), "OUT"))


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    ok, f = cap.read()
    while ok:
        out.append(f)
        ok, f = cap.read()
    cap.release()
    return np.stack(out)


def test_overlay_matches_jax(tmp_path, monkeypatch, capsys):
    _tree(tmp_path)
    got, ref = _run_both(tmp_path, monkeypatch, capsys)
    muxable = jnative._lib("media_mux", jnative._cfg_media_mux) is not None
    assert got == ref == {"pairs": 2, "muxed": 2 if muxable else 0, "backend": "native-libav"}
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    sub = "test/a"
    np.testing.assert_array_equal(_frames(tmp_path / "port" / sub / "clip1_landmarks.mp4"),
                                  _frames(tmp_path / "jax" / sub / "clip1_landmarks.mp4"))
    assert not (tmp_path / "port" / sub / "clip2_landmarks.mp4").exists()
    for name in ("clip1", "clip2"):
        a, sr = read_wav(tmp_path / "port" / sub / f"{name}_denoised.wav")
        b, sr_ref = read_wav(tmp_path / "jax" / sub / f"{name}_denoised.wav")
        assert sr == sr_ref == 16_000 and a.shape == b.shape
        assert np.abs(a - b).max() <= DENOISE_TOL * np.abs(b).max()
        assert abs(np.abs(b).max() - 0.95) < 1e-3                 # peak-normalised
        if muxable:
            out = tmp_path / "port" / sub / f"{name}_overlay.mp4"
            assert tnative.probe_audio_sample_rate(out) == 16_000
            np.testing.assert_array_equal(            # video packets stream-copied
                _frames(out), _frames(tmp_path / "jax" / sub / f"{name}_overlay.mp4"))


def test_overlay_without_a_mux_backend_matches_jax(tmp_path, monkeypatch, capsys):
    """The port's shim as on a machine without libav headers (cc fails), the
    JAX loader's shim absent: both pair and denoise, mux nothing, and name
    the shim as the backend."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "media_mux.c").write_text("#include <libavformat/not_installed.h>\n")
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIBS", {})
    monkeypatch.setattr(jnative, "_lib", lambda stem, configure: None)
    _tree(tmp_path)
    got, ref = _run_both(tmp_path, monkeypatch, capsys)
    assert got == ref == {"pairs": 2, "muxed": 0, "backend": "native-libav"}
    assert _manifest(tmp_path / "port") == _manifest(tmp_path / "jax")
    assert not list((tmp_path / "port").rglob("*_overlay.mp4"))
