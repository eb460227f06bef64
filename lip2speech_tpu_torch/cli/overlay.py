"""Overlay predicted audio onto source videos: listening copies (JAX
reference: cli/overlay.py).

Rebuild of reference overlay.py:12-71 with both its debug options:
--landmarks-dir draws the per-frame landmarks onto the video (reference
helpers.debug_video, in-image via cv2), --denoise-and-normalise runs the
normalize -> spectral-gate -> normalize chain (ops/denoise.preprocess_audio)
on each wav on --device: the card unless `--device cpu` (the JAX tool pins
its chain to the CPU). Muxing goes through the ffmpeg binary when present,
else the in-process libav shim (native/media_mux.c); a shim that does not
build leaves the pair unmuxed, as the JAX tool does. A manifest of
(video, wav, out) triples is always written.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def draw_landmarks_video(video_path: Path, landmarks_path: Path,
                         out_path: Path, fps: float = 25.0) -> bool:
    """Debug copy of the video with landmark dots (reference helpers.py
    debug_video / overlay.py:37-43). Returns False if cv2 can't decode."""
    try:
        import cv2
    except ImportError:
        return False
    if not hasattr(cv2, "VideoCapture"):  # a bare namespace package
        return False
    from lip2speech_tpu_torch.pipeline.landmarks import PrecomputedLandmarks

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return False
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    if not frames:
        return False
    lms = PrecomputedLandmarks(landmarks_path).load()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(out_path),
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame, lm in zip(frames, lms):
        if lm is not None:
            for x, y in np.asarray(lm, np.float64).reshape(-1, 2):
                cv2.circle(frame, (int(round(x)), int(round(y))), 2,
                           (0, 255, 0), -1)
        writer.write(frame)
    writer.release()
    return out_path.exists() and out_path.stat().st_size > 0


def overlay_audio(video_path: Path, wav_path: Path, out_path: Path) -> bool:
    """Mux wav over video (replacing its audio): the ffmpeg binary when
    present, else in-process through the native libav shim (stream-copied
    video + AAC audio, -shortest semantics). Returns False only when
    neither backend exists."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if ffmpeg_available():
        subprocess.run(
            ["ffmpeg", "-y", "-i", str(video_path), "-i", str(wav_path),
             "-map", "0:v", "-map", "1:a", "-c:v", "copy", "-shortest",
             str(out_path)],
            check=True, capture_output=True)
        return True
    from lip2speech_tpu_torch import native
    from lip2speech_tpu_torch.utils.audio_io import read_wav

    wav, sr = read_wav(wav_path)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    try:
        return native.mux_overlay(video_path, wav, sr, out_path)
    except native.BuildError:
        return False


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--video-dir", required=True)
    p.add_argument("--pred-wav-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--landmarks-dir",
                   help="draw <name>.pkl/.npy landmarks onto each video")
    p.add_argument("--denoise-and-normalise", action="store_true",
                   help="clean each wav before muxing")
    p.add_argument("--device", default=None,
                   help="device of the denoise chain (default: the card)")
    args = p.parse_args(argv)

    from lip2speech_tpu_torch.ops.denoise import preprocess_audio
    from lip2speech_tpu_torch.pipeline.synthesise import resolve_device
    from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

    dev = resolve_device(args.device) if args.denoise_and_normalise else None
    video_dir = Path(args.video_dir)
    wav_dir = Path(args.pred_wav_dir)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    pairs = []
    muxed = 0
    for wav in sorted(wav_dir.rglob("*.wav")):
        rel = wav.relative_to(wav_dir).with_suffix("")
        for ext in (".mp4", ".avi", ".mov"):
            video = video_dir / rel.parent / (rel.name + ext)
            if video.exists():
                break
        else:
            continue
        entry = {"video": str(video), "wav": str(wav)}
        if args.landmarks_dir:
            for lext in (".pkl", ".npy"):
                lm = Path(args.landmarks_dir) / rel.parent / (rel.name + lext)
                if lm.exists():
                    debug = out_dir / rel.parent / (rel.name + "_landmarks.mp4")
                    if draw_landmarks_video(video, lm, debug):
                        video = debug          # mux onto the debug copy
                        entry["landmarks_video"] = str(debug)
                    break
        if args.denoise_and_normalise:
            raw, sr = read_wav(wav)
            clean = out_dir / rel.parent / (rel.name + "_denoised.wav")
            clean.parent.mkdir(parents=True, exist_ok=True)
            with torch.inference_mode():
                den = preprocess_audio(torch.as_tensor(np.asarray(raw, np.float32), device=dev))
            write_wav(clean, den.cpu().numpy(), sr)
            wav = clean
            entry["denoised_wav"] = str(clean)
        out = out_dir / rel.parent / (rel.name + "_overlay.mp4")
        entry["out"] = str(out)
        pairs.append(entry)
        if overlay_audio(video, wav, out):
            muxed += 1

    (out_dir / "overlay_manifest.json").write_text(json.dumps(pairs, indent=2))
    summary = {"pairs": len(pairs), "muxed": muxed,
               "backend": "ffmpeg" if ffmpeg_available() else "native-libav"}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
