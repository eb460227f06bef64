"""Stage-1 dataset: mouth video + speaker embedding -> unit and mel targets
(the port's own copy of the JAX package's data/stage1.py; numpy only).

Batches are padded to a few fixed bucket lengths. Batch dict (numpy):
  video:        (B, T, 88, 88, 1) float32 normalised, or uint8 (emit_uint8)
  frames_mask:  (B, T) bool
  spk_emb:      (B, 256) float32
  unit_tokens:  (B, 2T + 1) int32: unit ids + num_special, EOS appended,
                PAD-filled (fairseq's LabelEncoderUnit)
  mel:          (B, 4T, 80) float32
  ids:          list[str]
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from lip2speech_tpu_torch.core.config import UnitConfig
from lip2speech_tpu_torch.data.manifest import read_manifest, units_to_tokens
from lip2speech_tpu_torch.data.transforms import UINT8_FILL, prepare_video
from lip2speech_tpu_torch.data.video_io import load_video_gray

DEFAULT_BUCKETS = (48, 96, 160, 240, 360, 480, 600)


def pick_bucket(n_frames: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n_frames <= b:
            return b
    return buckets[-1]


@dataclass
class Stage1Sample:
    uid: str
    video: np.ndarray       # (T, 88, 88) float32 normalised, or uint8
    spk_emb: np.ndarray     # (256,)
    units: np.ndarray | None
    mel: np.ndarray | None  # (Tm, 80)


class Stage1Dataset:
    def __init__(self, tsv_path: str | Path, unt_path: str | Path | None = None,
                 root_override: str | Path | None = None, train: bool = False,
                 crop_size: int = 88, max_frames: int = 600, random_erase: bool = False,
                 time_mask: bool = False, seed: int = 0, units_cfg: UnitConfig = UnitConfig(),
                 emit_uint8: bool = False):
        self.utts = read_manifest(tsv_path, unt_path, root_override)
        self.train = train
        self.crop_size = crop_size
        self.max_frames = max_frames
        self.random_erase = random_erase
        self.time_mask = time_mask
        self.units_cfg = units_cfg
        self.emit_uint8 = emit_uint8
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.utts)

    def load(self, idx: int) -> Stage1Sample:
        utt = self.utts[idx]
        frames = load_video_gray(utt.video_path)[: self.max_frames]
        video = prepare_video(frames, self.crop_size, self.train, self.rng,
                              self.random_erase, self.time_mask, emit_uint8=self.emit_uint8)
        spk = np.load(utt.spk_emb_path).astype(np.float32)
        mel = np.load(utt.mel_path).astype(np.float32) if utt.mel_path.exists() else None
        return Stage1Sample(utt.uid, video, spk, utt.units, mel)

    def collate(self, samples: list[Stage1Sample], pad_to: int | None = None) -> dict:
        cfg = self.units_cfg
        max_t = max(s.video.shape[0] for s in samples)
        t = max(pad_to if pad_to is not None else pick_bucket(max_t), max_t)
        b = len(samples)
        size = samples[0].video.shape[1]
        if self.emit_uint8:
            video = np.full((b, t, size, size, 1), UINT8_FILL, np.uint8)
        else:
            video = np.zeros((b, t, size, size, 1), np.float32)
        mask = np.zeros((b, t), bool)
        spk = np.zeros((b, 256), np.float32)
        units = np.full((b, cfg.units_per_frame * t + 1), cfg.pad, np.int32)
        mel = np.zeros((b, cfg.mel_per_frame * t, 80), np.float32)
        ids = []
        for i, s in enumerate(samples):
            n = s.video.shape[0]
            video[i, :n, :, :, 0] = s.video
            mask[i, :n] = True
            spk[i] = s.spk_emb
            ids.append(s.uid)
            if s.units is not None:
                toks = units_to_tokens(s.units[: cfg.units_per_frame * n], cfg)
                units[i, : len(toks)] = toks
            if s.mel is not None:
                m = s.mel[: cfg.mel_per_frame * n]
                mel[i, : len(m)] = m
        return {"video": video, "frames_mask": mask, "spk_emb": spk,
                "unit_tokens": units, "mel": mel, "ids": ids}

    def batches(self, batch_size: int | None = None, shuffle: bool = False,
                frames_budget: int | None = None):
        """Collated batches grouped by length bucket. With shuffle the clips
        are shuffled, then the batch order across buckets; without, buckets
        in ascending order. frames_budget batches by frame count instead:
        each bucket's batch size is max(1, frames_budget // bucket)."""
        if (batch_size is None) == (frames_budget is None):
            raise ValueError("pass exactly one of batch_size / frames_budget")
        order = np.arange(len(self.utts))
        if shuffle:
            self.rng.shuffle(order)
        by_bucket: dict[int, list[int]] = {}
        for idx in order:
            bkt = pick_bucket(min(self.utts[idx].n_frames, self.max_frames))
            by_bucket.setdefault(bkt, []).append(int(idx))

        def _bs(bkt: int) -> int:
            return max(1, frames_budget // bkt) if frames_budget is not None else batch_size

        plan = [(bkt, idxs[i: i + _bs(bkt)])
                for bkt, idxs in sorted(by_bucket.items())
                for i in range(0, len(idxs), _bs(bkt))]
        if shuffle:
            self.rng.shuffle(plan)
        for bkt, chunk in plan:
            yield self.collate([self.load(j) for j in chunk], pad_to=bkt)
