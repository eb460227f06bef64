"""Host media helpers: dim clamping, fps planning, in-process transcodes (the
port's copy of the JAX package's pipeline/media.py; no device work).

Rebuild of the reference's media utilities (helpers.py:26-416). Three tiers:
geometry/planning logic is pure python; audio extraction and container
probing run in-process through the native libav shim
(native/media_demux.c); video transforms (resize, fps, segment crop,
concat) run in-process through cv2's decoder/encoder. The ffmpeg argv
builders remain the preferred path where the binary exists, because only it
keeps audio tracks through video transforms (`-c:a copy`). Choosing among
cv2, the shim and ffmpeg is a choice of decoder, not of device: the order
and the None / False results where no backend exists are the JAX module's.
A shim that does not build raises native.BuildError, which these helpers
catch (and nothing else) to try the next backend.

Two departures from the JAX module, on purpose:
  * change_fps plans its output from the frames that decode: when the
    container reports more frames (CAP_PROP_FRAME_COUNT) than decode, the
    JAX copy indexes a frame it never read and raises KeyError;
  * extract_audio falls back to the ffmpeg binary also when dst is None
    (into a temporary wav), as its docstring says; the JAX copy returns None.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

MAX_W, MAX_H = 480, 360   # reference config.py DIM_1/DIM_2
FPS = 25


def get_updated_dims(width: int, height: int,
                     max_w: int = MAX_W, max_h: int = MAX_H) -> tuple[int, int]:
    """Aspect-preserving clamp to <= (max_w, max_h), even dims
    (reference helpers.py get_updated_dims semantics)."""
    if width <= max_w and height <= max_h:
        w, h = width, height
    else:
        scale = min(max_w / width, max_h / height)
        w, h = int(width * scale), int(height * scale)
    return w - (w % 2), h - (h % 2)


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def resize_cmd(src: str | Path, dst: str | Path, width: int, height: int) -> list[str]:
    return ["ffmpeg", "-y", "-i", str(src), "-vf", f"scale={width}:{height}",
            "-c:a", "copy", str(dst)]


def fps_cmd(src: str | Path, dst: str | Path, fps: int = FPS) -> list[str]:
    return ["ffmpeg", "-y", "-i", str(src), "-filter:v", f"fps={fps}",
            "-c:a", "copy", str(dst)]


def extract_audio_cmd(src: str | Path, dst: str | Path, sr: int = 16_000) -> list[str]:
    return ["ffmpeg", "-y", "-i", str(src), "-vn", "-ac", "1", "-ar", str(sr),
            "-f", "wav", str(dst)]


def concat_cmd(list_file: str | Path, dst: str | Path) -> list[str]:
    """VSG segment stitching (reference vsg_service.py ffmpeg concat /
    MERGE_VIDEOS_COMMAND, helpers.py:35)."""
    return ["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i", str(list_file),
            "-c", "copy", str(dst)]


def pad_audio_start_cmd(src: str | Path, dst: str | Path, delay_s: int) -> list[str]:
    """Prepend delay_s seconds of silence (PAD_AUDIO_START_COMMAND,
    helpers.py:32: adelay per channel in ms)."""
    ms = int(delay_s) * 1000
    return ["ffmpeg", "-y", "-i", str(src),
            "-af", f"adelay={ms}|{ms}", str(dst)]


def pad_audio_end_cmd(src: str | Path, dst: str | Path, delay_s: float) -> list[str]:
    """Append silence (PAD_AUDIO_END_COMMAND, helpers.py:33)."""
    return ["ffmpeg", "-y", "-i", str(src),
            "-af", f"apad=pad_dur={delay_s}", str(dst)]


def remove_audio_pad_cmd(src: str | Path, dst: str | Path, delay_s: int) -> list[str]:
    """Drop the first delay_s seconds (REMOVE_AUDIO_PAD_COMMAND, helpers.py:34)."""
    return ["ffmpeg", "-y", "-i", str(src), "-ss", f"00:00:{int(delay_s):02d}.000",
            "-acodec", "pcm_s16le", str(dst)]


def crop_video_cmd(src: str | Path, dst: str | Path,
                   start_s: float, end_s: float) -> list[str]:
    """Time-segment crop (CROP_VIDEO_FAST_COMMAND, helpers.py:37)."""
    return ["ffmpeg", "-y", "-ss", _ffmpeg_time(start_s), "-to",
            _ffmpeg_time(end_s), "-i", str(src), str(dst)]


def crop_video_multiple_cmd(src: str | Path,
                            segments: list[tuple[float, float, str]]) -> list[str]:
    """Several segment crops in ONE ffmpeg run (CROP_VIDEO_MULTIPLE_COMMAND,
    helpers.py:38 + avspeech usage). segments: (start_s, end_s, out_path)."""
    cmd = ["ffmpeg", "-y", "-i", str(src)]
    for start_s, end_s, out in segments:
        cmd += ["-ss", _ffmpeg_time(start_s), "-to", _ffmpeg_time(end_s), str(out)]
    return cmd


def speed_cmd(src: str | Path, dst: str | Path, speed: float) -> list[str]:
    """Speed-alter video+audio together (VIDEO_SPEED_ALTER_COMMAND,
    helpers.py:39: setpts 1/speed on video, atempo speed on audio)."""
    return ["ffmpeg", "-y", "-i", str(src), "-filter_complex",
            f"[0:v]setpts={1.0 / speed}*PTS[v];[0:a]atempo={speed}[a]",
            "-map", "[v]", "-map", "[a]", str(dst)]


def normalize_audio_cmd(src: str | Path, dst: str | Path,
                        sr: int = 16_000) -> list[str]:
    """EBU R128 loudness normalization — in-process equivalent of the
    reference's ffmpeg-normalize wrapper (NORMALISE_AUDIO_COMMAND,
    helpers.py:31, which drives the same loudnorm filter)."""
    return ["ffmpeg", "-y", "-i", str(src),
            "-af", "loudnorm=I=-23.0:LRA=7.0:TP=-2.0",
            "-ar", str(sr), str(dst)]


def _ffmpeg_time(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int(seconds % 3600 // 60)
    s = seconds % 60
    return f"{h:02d}:{m:02d}:{s:06.3f}"


# formats ffprobe may report that are not real videos (helpers.py:41)
INVALID_VIDEO_FORMATS = ("image2", "tty", "ico", "gif", "pipe")


def probe(path: str | Path) -> dict:
    """ffprobe JSON (streams + format); {} when ffprobe is unavailable."""
    import json

    if shutil.which("ffprobe") is None:
        return {}
    out = subprocess.run(
        ["ffprobe", "-v", "quiet", "-print_format", "json",
         "-show_streams", "-show_format", str(path)],
        capture_output=True, check=False)
    if out.returncode != 0:
        return {}  # corrupt / non-media input: callers treat {} as invalid
    try:
        return json.loads(out.stdout or b"{}")
    except ValueError:
        return {}


def get_fps(path: str | Path) -> float | None:
    info = probe(path)
    for s in info.get("streams", []):
        if s.get("codec_type") == "video":
            num, den = s["r_frame_rate"].split("/")
            return float(num) / float(den)
    return None


def get_duration_s(path: str | Path) -> float | None:
    info = probe(path)
    dur = info.get("format", {}).get("duration")
    return float(dur) if dur is not None else None


def is_valid_video_format(path: str | Path) -> bool | None:
    """False for the pseudo-video formats the gateway rejects
    (helpers.py:41 INVALID_VIDEO_FORMATS); None when ffprobe is absent."""
    info = probe(path)
    if not info:
        return None
    fmt = info.get("format", {}).get("format_name", "")
    return not any(bad in fmt.split(",") for bad in INVALID_VIDEO_FORMATS)


def run(cmd: list[str]) -> bool:
    if not ffmpeg_available():
        return False
    subprocess.run(cmd, check=True, capture_output=True)
    return True


# ---------------------------------------------------------------------------
# in-process implementations (no ffmpeg binary required)


def extract_audio(src: str | Path, dst: str | Path | None = None,
                  sr: int = 16_000):
    """Audio track of any container -> mono float32 at sr, in-process via
    the native libav shim (reference: EXTRACT_AUDIO_COMMAND subprocess).
    Writes a wav when dst is given. Falls back to the ffmpeg binary; returns
    None only when neither backend exists."""
    from lip2speech_tpu_torch import native
    from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

    try:
        audio = native.decode_audio(src, sr)
    except native.BuildError:
        audio = None
    if audio is None and ffmpeg_available():
        with tempfile.TemporaryDirectory(prefix="extract_audio_") as tmp:
            wav = Path(tmp) / "audio.wav" if dst is None else dst
            run(extract_audio_cmd(src, wav, sr))
            return read_wav(wav)[0]
    if audio is not None and dst is not None:
        write_wav(dst, audio, sr)
    return audio


def has_audio_stream(path: str | Path) -> bool | None:
    """True/False via the native probe; None when no backend exists."""
    from lip2speech_tpu_torch import native

    try:
        sr = native.probe_audio_sample_rate(path)
    except native.BuildError:
        return None
    except ValueError:
        return False
    return sr > 0


def video_props(path: str | Path) -> dict | None:
    """fps / frame count / dims / duration via cv2 (in-process ffprobe
    subset); None when cv2 can't open the file."""
    try:
        import cv2
    except ImportError:
        return None
    if not hasattr(cv2, "VideoCapture"):
        return None
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return None
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    props = {
        "fps": float(fps),
        "frame_count": n,
        "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0),
        "duration_s": (n / fps) if fps > 0 else None,
    }
    cap.release()
    return props


def _transcode(src: str | Path, dst: str | Path, frame_fn, out_fps=None,
               frame_range=None) -> bool:
    """Stream src through cv2 decode -> frame_fn -> mp4v encode. Video-only
    (cv2 cannot mux audio; the ffmpeg argv path keeps audio when the binary
    exists). frame_range: (first, last) source-frame indices inclusive."""
    try:
        import cv2
    except ImportError:
        return False
    if not hasattr(cv2, "VideoCapture"):
        return False
    cap = cv2.VideoCapture(str(src))
    if not cap.isOpened():
        return False
    src_fps = cap.get(cv2.CAP_PROP_FPS) or FPS
    writer = None
    i = -1
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            i += 1
            if frame_range is not None and not (
                    frame_range[0] <= i <= frame_range[1]):
                if i > frame_range[1]:
                    break
                continue
            out = frame_fn(frame)
            if out is None:
                continue
            if writer is None:
                h, w = out.shape[:2]
                writer = cv2.VideoWriter(
                    str(dst), cv2.VideoWriter_fourcc(*"mp4v"),
                    out_fps or src_fps, (w, h))
                if not writer.isOpened():
                    return False
            writer.write(out)
        return writer is not None
    finally:
        cap.release()
        if writer is not None:
            writer.release()


def resize_video(src: str | Path, dst: str | Path, width: int,
                 height: int) -> bool:
    """In-process `-vf scale=W:H` (reference RESIZE_VIDEO_COMMAND)."""
    if ffmpeg_available():
        return run(resize_cmd(src, dst, width, height))
    import cv2

    return _transcode(src, dst, lambda f: cv2.resize(f, (width, height)))


def change_fps(src: str | Path, dst: str | Path, fps: int = FPS) -> bool:
    """In-process `-filter:v fps=N` (reference FPS_CHANGE_COMMAND): nearest
    source frame per output tick, the same policy ffmpeg's fps filter uses
    for CFR output."""
    if ffmpeg_available():
        return run(fps_cmd(src, dst, fps))
    props = video_props(src)
    if props is None or not props["fps"]:
        return False
    src_fps, n = props["fps"], props["frame_count"]
    n_out = max(1, int(round(n * fps / src_fps)))
    # CFR resample: nearest source frame per output tick (frames may repeat
    # when increasing fps or drop when decreasing) — two passes: collect the
    # wanted source frames, then write with repeats
    wanted = {min(n - 1, int(round(j * src_fps / fps)))
              for j in range(n_out)}
    try:
        import cv2
    except ImportError:
        return False
    cap = cv2.VideoCapture(str(src))
    if not cap.isOpened():
        return False
    frames = {}
    i = -1
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        i += 1
        if i in wanted:
            frames[i] = frame
        last = frame
    cap.release()
    if not frames:
        return False
    if i < n - 1:
        # fewer frames decode than the container reports: plan over those
        # that did (the new plan needs the old plan's indices below i, and i)
        frames[i] = last
        n = i + 1
        n_out = max(1, int(round(n * fps / src_fps)))
    h, w = next(iter(frames.values())).shape[:2]
    writer = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (w, h))
    if not writer.isOpened():
        return False
    for j in range(n_out):
        k = min(n - 1, int(round(j * src_fps / fps)))
        writer.write(frames[k])
    writer.release()
    return True


def crop_video(src: str | Path, dst: str | Path, start_s: float,
               end_s: float) -> bool:
    """In-process time-segment crop (CROP_VIDEO_FAST_COMMAND)."""
    if ffmpeg_available():
        return run(crop_video_cmd(src, dst, start_s, end_s))
    props = video_props(src)
    if props is None or not props["fps"]:
        return False
    fps = props["fps"]
    first = max(0, int(round(start_s * fps)))
    last = min(props["frame_count"] - 1, int(round(end_s * fps)) - 1)
    if last < first:
        return False
    return _transcode(src, dst, lambda f: f, frame_range=(first, last))


def concat_videos(sources: list[str | Path], dst: str | Path) -> bool:
    """In-process segment stitch (MERGE_VIDEOS_COMMAND / vsg concat).
    Sources must share dims; output fps = first source's."""
    props = video_props(sources[0]) if sources else None
    if props is None:
        return False
    try:
        import cv2
    except ImportError:
        return False
    writer = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*"mp4v"),
                             props["fps"] or FPS,
                             (props["width"], props["height"]))
    if not writer.isOpened():
        return False
    try:
        for src in sources:
            cap = cv2.VideoCapture(str(src))
            if not cap.isOpened():
                return False
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if frame.shape[:2] != (props["height"], props["width"]):
                    cap.release()
                    return False
                writer.write(frame)
            cap.release()
        return True
    finally:
        writer.release()


def pad_audio_start(src: str | Path, dst: str | Path, delay_s: float) -> bool:
    """In-process PAD_AUDIO_START_COMMAND (adelay): prepend silence."""
    import numpy as np

    from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

    audio, sr = read_wav(src)
    write_wav(dst, np.concatenate(
        [np.zeros(int(round(delay_s * sr)), audio.dtype), audio]), sr)
    return True


def pad_audio_end(src: str | Path, dst: str | Path, delay_s: float) -> bool:
    """In-process PAD_AUDIO_END_COMMAND (apad): append silence."""
    import numpy as np

    from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

    audio, sr = read_wav(src)
    write_wav(dst, np.concatenate(
        [audio, np.zeros(int(round(delay_s * sr)), audio.dtype)]), sr)
    return True


def remove_audio_pad(src: str | Path, dst: str | Path,
                     delay_s: float) -> bool:
    """In-process REMOVE_AUDIO_PAD_COMMAND: drop the first delay_s
    seconds."""
    from lip2speech_tpu_torch.utils.audio_io import read_wav, write_wav

    audio, sr = read_wav(src)
    write_wav(dst, audio[int(round(delay_s * sr)):], sr)
    return True
