"""Dataset creation CLI (JAX reference: cli/create_dataset.py).

Rebuild of reference create_dataset.py:34-571 subcommands, with video
arriving as .npy grayscale sidecars (or any container a decoder of
data/video_io.py reads):

  init       per-clip prep: mouth-ROI crop from landmarks (.npy, (T, 68, 2),
             or detected in-process), the dataset mel and the GE2E speaker
             d-vector (on --device: the card unless `--device cpu`), the
             audio copied or extracted from the clip
  manifests  TSV + .unt manifests from the prepared tree
  vocoder    stage-2 dir from stage-1 predictions (pred_mel / pred_unit)
  combine    several trees symlink-merged under new ids

Each clip's mel and d-vector are one device call; with `--workers N` the
host work of the clips runs on N threads and every device call on one
thread of its own (cuDNN's plans are kept per thread).

`--speaker-encoder` takes "random" (drawn from a torch.Generator at seed 0,
so its weights differ from the JAX package's, which come from
jax.random.PRNGKey(0)), an RTVC encoder .pt (a flat state_dict, through
models/speaker.convert_rtvc_encoder), or a port file {"speaker":
state_dict} (cli/convert.py --kind speaker, or scripts/orbax_to_torch.py on
the JAX package's orbax directory). A directory is refused: convert it
first.
"""

from __future__ import annotations

import argparse
import os
import shutil
import wave as wavemod
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from lip2speech_tpu_torch.core.config import AudioConfig
from lip2speech_tpu_torch.data.manifest import (
    Utterance,
    read_manifest,
    write_manifest,
    write_unit_dictionary,
    write_units,
)
from lip2speech_tpu_torch.data.video_io import load_video_gray, save_video_gray
from lip2speech_tpu_torch.models.speaker import SpeakerEncoder, embed_utterance
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device
from lip2speech_tpu_torch.utils.audio_io import read_wav


@torch.inference_mode()
def extract_mel(wav: np.ndarray, audio: AudioConfig = AudioConfig(),
                device: str | torch.device | None = None) -> np.ndarray:
    """Tacotron-style dataset mel (create_dataset.py:62-75 semantics) of a
    1-D waveform, computed on `device` (None: the card)."""
    from lip2speech_tpu_torch.ops.dsp import mel_spectrogram_dataset

    y = torch.as_tensor(np.asarray(wav, np.float32), device=resolve_device(device))
    return mel_spectrogram_dataset(
        y[None], audio.sample_rate, audio.n_fft, audio.hop_length, audio.win_length,
        audio.num_mels, audio.fmin, audio.fmax)[0].cpu().numpy()


def _direct(fn, *args):
    return fn(*args)


def init_sample(video_path: Path, audio_path: Path | None, out_root: Path,
                rel_id: str,
                landmarks_path: Path | None = None,
                spk_emb_path: Path | None = None,
                mean_face: np.ndarray | None = None,
                speaker_encoder: SpeakerEncoder | None = None,
                auto_landmarks: bool = False,
                device: str | torch.device | None = None,
                device_call=_direct) -> Utterance:
    """Prepare one utterance into the dataset tree layout
    (video/ audio/ mel/ spk_emb/ — reference config.py:39-49).

    audio_path=None extracts the clip's own audio track in-process
    (pipeline/media.extract_audio: the libav shim, then ffmpeg).

    Speaker embedding priority: an explicit .npy > the GE2E d-vector of the
    clip's own audio (speaker_encoder, on its device) > zeros. The mel runs
    on `device`; both device calls go through device_call(fn, *args)."""
    frames = load_video_gray(video_path)
    if landmarks_path is not None or auto_landmarks:
        from lip2speech_tpu_torch.pipeline.mouth_crop import (
            crop_mouth_sequence, default_mean_face)

        if landmarks_path is not None:
            lms = list(np.load(landmarks_path))
        else:   # dlib-free in-process detection (raw video, no sidecar)
            from lip2speech_tpu_torch.pipeline.landmarks import default_landmarker

            lms = default_landmarker()(frames)
        frames = crop_mouth_sequence(
            frames, lms, mean_face if mean_face is not None else default_mean_face())

    save_video_gray(out_root / "video" / f"{rel_id}.mp4", frames)

    dst_audio = out_root / "audio" / f"{rel_id}.wav"
    dst_audio.parent.mkdir(parents=True, exist_ok=True)
    if audio_path is None:
        from lip2speech_tpu_torch.pipeline.media import extract_audio

        sr = AudioConfig().sample_rate
        wav = extract_audio(video_path, dst_audio, sr=sr)
        if wav is None:
            raise RuntimeError(
                f"no audio sidecar for {video_path} and no in-process "
                f"audio backend (native libav shim / ffmpeg)")
    else:
        wav, sr = read_wav(audio_path)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        shutil.copyfile(audio_path, dst_audio)

    mel = device_call(extract_mel, wav, AudioConfig(), device)
    mel_path = out_root / "mel" / f"{rel_id}.npy"
    mel_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(mel_path, mel)

    spk_path = out_root / "spk_emb" / f"{rel_id}.npy"
    spk_path.parent.mkdir(parents=True, exist_ok=True)
    if spk_emb_path is not None:
        np.save(spk_path, np.load(spk_emb_path).astype(np.float32))
    elif speaker_encoder is not None:
        np.save(spk_path, device_call(embed_utterance, speaker_encoder, wav, sr))
    else:
        np.save(spk_path, np.zeros(256, np.float32))

    return Utterance(uid=rel_id, video_path=Path("video") / f"{rel_id}.mp4",
                     audio_path=Path("audio") / f"{rel_id}.wav",
                     n_frames=len(frames), n_samples=len(wav))


def build_manifests(root: Path, split: str, utts: list[Utterance],
                    unit_rows: list[np.ndarray] | None = None) -> None:
    """TSV (+ .unt + dict) under root/label (create_dataset.py:331-363)."""
    label = root / "label"
    write_manifest(label / f"{split}.tsv", root, utts)
    write_unit_dictionary(label / "dict.unt.txt")
    if unit_rows is not None:
        write_units(label / f"{split}.unt", unit_rows)
    else:
        # serving placeholder: constant units sized 2x frames (server.py:258-285)
        write_units(label / f"{split}.unt",
                    [np.zeros(2 * u.n_frames, np.int32) for u in utts])


def rebuild_manifests(root: Path, split: str) -> list[Utterance]:
    """Scan an existing dataset tree and (re)write label/<split>.tsv (+ .unt
    placeholder when absent or stale) — the reference 'manifests'
    subcommand (create_dataset.py:331-363)."""
    video_dir = root / "video" / split
    utts: list[Utterance] = []
    vids = sorted(list(video_dir.rglob("*.mp4")) + list(video_dir.rglob("*.npy")))
    seen = set()
    for v in vids:
        uid = f"{split}/{v.relative_to(video_dir).with_suffix('')}"
        if uid in seen:  # .mp4 + .npy sidecar pair counts once
            continue
        seen.add(uid)
        n_frames = len(load_video_gray(v))
        audio = root / "audio" / f"{uid}.wav"
        if audio.exists():
            with wavemod.open(str(audio)) as w:
                n_samples = w.getnframes()
        else:
            n_samples = n_frames * 640
        utts.append(Utterance(uid=uid, video_path=Path("video") / f"{uid}.mp4",
                              audio_path=Path("audio") / f"{uid}.wav",
                              n_frames=n_frames, n_samples=n_samples))
    unt = root / "label" / f"{split}.unt"
    existing_units = None
    if unt.exists():
        existing_units = [np.array([int(x) for x in line.split()], np.int32)
                          for line in unt.read_text().splitlines()]
        if len(existing_units) != len(utts):
            existing_units = None  # stale; regenerate placeholder
    build_manifests(root, split, utts, existing_units)
    return utts


def load_speaker_encoder(spec: str, device: str | torch.device | None = None) -> SpeakerEncoder:
    """The GE2E encoder of `spec` on `device` (None: the card): 'random'
    (every parameter uniform in +-1/sqrt(256), the JAX init_params' range,
    drawn in order from a torch.Generator at seed 0), a port file
    {"speaker": state_dict}, or an RTVC encoder .pt (a flat state_dict, read
    weights-only)."""
    from lip2speech_tpu_torch.models.speaker import convert_rtvc_encoder
    from lip2speech_tpu_torch.train.checkpoint import is_port_checkpoint

    dev = resolve_device(device)
    enc = SpeakerEncoder()
    if spec == "random":
        gen = torch.Generator().manual_seed(0)
        bound = 1.0 / np.sqrt(enc.lstm.hidden_size)
        with torch.no_grad():
            for p in enc.parameters():
                p.uniform_(-bound, bound, generator=gen)
        return enc.to(dev).eval()
    if Path(spec).is_dir():
        raise ValueError(f"{spec} is a directory: convert an orbax speaker encoder "
                         f"with scripts/orbax_to_torch.py first")
    obj = torch.load(spec, map_location="cpu", weights_only=True)
    enc.load_state_dict(obj["speaker"] if is_port_checkpoint(obj) else convert_rtvc_encoder(obj),
                        strict=True)
    return enc.to(dev).eval()


def setup_vocoder_dir(dataset_root: Path, synthesis_dir: Path, out_root: Path,
                      split: str = "test") -> None:
    """Stage-2 input dir from stage-1 predictions (create_dataset.py:366-428):
    copy audio/spk_emb trees, swap mel -> pred_mel and units -> pred_unit."""
    utts = read_manifest(dataset_root / "label" / f"{split}.tsv",
                         root_override=dataset_root)
    out_root.mkdir(parents=True, exist_ok=True)
    rows = []
    kept = []
    for u in utts:
        pred_mel = synthesis_dir / "pred_mel" / f"{u.uid}.npy"
        pred_unit = synthesis_dir / "pred_unit" / f"{u.uid}.txt"
        if not (pred_mel.exists() and pred_unit.exists()):
            continue
        for src, sub in [(u.audio_path, "audio"), (u.spk_emb_path, "spk_emb")]:
            dst = out_root / sub / (u.uid + src.suffix)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, dst)
        mel_dst = out_root / "mel" / f"{u.uid}.npy"
        mel_dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(pred_mel, mel_dst)
        rows.append(np.array([int(x) for x in pred_unit.read_text().split()],
                             np.int32))
        kept.append(Utterance(u.uid, Path("video") / f"{u.uid}.mp4",
                              Path("audio") / f"{u.uid}.wav",
                              u.n_frames, u.n_samples))
    build_manifests(out_root, split, kept, rows)


def combine_datasets(roots: list[Path], out_root: Path, split: str) -> None:
    """Symlink-merge multiple dataset trees + concatenated manifests
    (reference create_dataset.py 'combine' subcommand)."""
    all_utts: list[Utterance] = []
    all_units: list[np.ndarray] = []
    for d_idx, root in enumerate(roots):
        utts = read_manifest(root / "label" / f"{split}.tsv",
                             root / "label" / f"{split}.unt",
                             root_override=root)
        for u in utts:
            new_id = f"{split}/d{d_idx}/{u.uid.replace('/', '_')}"
            for src, sub in [(u.video_path, "video"), (u.audio_path, "audio"),
                             (u.mel_path, "mel"), (u.spk_emb_path, "spk_emb")]:
                # video may only exist as a .npy sidecar
                for cand in (src, src.with_suffix(".npy")):
                    if cand.exists():
                        dst = out_root / sub / (new_id + cand.suffix)
                        dst.parent.mkdir(parents=True, exist_ok=True)
                        if not dst.exists():
                            os.symlink(cand.resolve(), dst)
            all_utts.append(Utterance(new_id, Path("video") / f"{new_id}.mp4",
                                      Path("audio") / f"{new_id}.wav",
                                      u.n_frames, u.n_samples))
            all_units.append(u.units)
    build_manifests(out_root, split, all_utts, all_units)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    p_init = sub.add_parser("init")
    p_init.add_argument("--videos", nargs="+", required=True)
    p_init.add_argument("--audios", nargs="*", default=None,
                        help="per-clip wav files; omit to extract each "
                             "clip's own audio track in-process (native "
                             "libav shim, then ffmpeg)")
    p_init.add_argument("--landmarks", nargs="*", default=None,
                        help="per-clip 68-point landmark .npy files (raw video "
                             "is mouth-cropped in-process)")
    p_init.add_argument("--auto-landmarks", action="store_true",
                        help="raw video without landmark files: detect with "
                             "the in-tree dlib-free detector (trained Haar "
                             "cascade when available, saliency heuristic "
                             "otherwise)")
    p_init.add_argument("--spk-embs", nargs="*", default=None,
                        help="per-clip precomputed speaker-embedding .npy files")
    p_init.add_argument("--speaker-encoder", default=None,
                        help="GE2E encoder for d-vectors from each clip's own "
                             "audio: 'random', an RTVC .pt, or a port file "
                             "{'speaker': state_dict}")
    p_init.add_argument("--workers", type=int, default=1,
                        help="threads for the per-clip host work (reference "
                             "create_dataset.py:312-315 uses multiprocessing); "
                             "device calls stay on one thread")
    p_init.add_argument("--out-root", required=True)
    p_init.add_argument("--split", default="test")
    p_init.add_argument("--device", default=None,
                        help="device of the mel and d-vectors (default: the card)")

    p_man = sub.add_parser("manifests")
    p_man.add_argument("--root", required=True)
    p_man.add_argument("--split", default="test")

    p_voc = sub.add_parser("vocoder")
    p_voc.add_argument("--dataset-root", required=True)
    p_voc.add_argument("--synthesis-dir", required=True)
    p_voc.add_argument("--out-root", required=True)
    p_voc.add_argument("--split", default="test")

    p_comb = sub.add_parser("combine")
    p_comb.add_argument("--roots", nargs="+", required=True)
    p_comb.add_argument("--out-root", required=True)
    p_comb.add_argument("--split", default="train")

    args = p.parse_args(argv)
    if args.cmd == "init":
        out_root = Path(args.out_root)
        dev = resolve_device(args.device)
        encoder = (load_speaker_encoder(args.speaker_encoder, dev)
                   if args.speaker_encoder else None)
        n = len(args.videos)

        def job(i, device_call=_direct):
            a = Path(args.audios[i]) if args.audios else None
            lm = Path(args.landmarks[i]) if args.landmarks else None
            se = Path(args.spk_embs[i]) if args.spk_embs else None
            return init_sample(Path(args.videos[i]), a, out_root,
                               f"{args.split}/clip/{i:05d}",
                               landmarks_path=lm, spk_emb_path=se,
                               speaker_encoder=encoder,
                               auto_landmarks=args.auto_landmarks,
                               device=dev, device_call=device_call)

        if args.workers > 1:
            # threads, as the JAX CLI: per-clip host work is numpy / decoder
            # bound and releases the GIL; the device calls queue on one thread
            with ThreadPoolExecutor(1, thread_name_prefix="device") as on_device, \
                    ThreadPoolExecutor(args.workers) as pool:
                def device_call(fn, *a):
                    return on_device.submit(fn, *a).result()

                utts = list(pool.map(lambda i: job(i, device_call), range(n)))
        else:
            utts = [job(i) for i in range(n)]
        build_manifests(out_root, args.split, utts)
        return utts
    if args.cmd == "manifests":
        utts = rebuild_manifests(Path(args.root), args.split)
        print(f"wrote manifests for {len(utts)} utterances")
        return utts
    if args.cmd == "vocoder":
        setup_vocoder_dir(Path(args.dataset_root), Path(args.synthesis_dir),
                          Path(args.out_root), args.split)
    else:
        combine_datasets([Path(r) for r in args.roots], Path(args.out_root),
                         args.split)
    return None


if __name__ == "__main__":
    main()
