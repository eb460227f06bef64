"""Stage-2 (vocoder) dataset: units + mel + speaker + target waveform (the
port's own copy of the JAX package's data/stage2.py; numpy only).

  * audio peak-normalised x 0.95 (librosa normalize);
  * audio, mel and code trimmed to a common hop-aligned length (code hop
    320 at 16 kHz = 50 Hz units, mel hop 160 = 100 Hz);
  * short clips tiled to >= segment_size, then a random aligned
    8,960-sample (0.56 s) training segment;
  * |code| must be 2x the video frames, +-2;
  * with mel_aug, training mels are blurred and noised (mel_blur_noise).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from lip2speech_tpu_torch.core.config import VocoderConfig
from lip2speech_tpu_torch.data.manifest import read_manifest
from lip2speech_tpu_torch.data.transforms import mel_blur_noise
from lip2speech_tpu_torch.utils.audio_io import peak_normalize, read_wav


@dataclass
class Stage2Sample:
    uid: str
    audio: np.ndarray   # (N,) float32, hop-aligned with code and mel
    code: np.ndarray    # (N / 320,) int32
    mel: np.ndarray     # (N / 160, 80) float32
    spk_emb: np.ndarray


class Stage2Dataset:
    def __init__(self, tsv_path: str | Path, unt_path: str | Path,
                 cfg: VocoderConfig = VocoderConfig(), root_override: str | Path | None = None,
                 train: bool = True, mel_aug: bool = False, seed: int = 1234):
        self.utts = read_manifest(tsv_path, unt_path, root_override)
        self.cfg = cfg
        self.train = train
        self.mel_aug = mel_aug
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.utts)

    def load(self, idx: int) -> Stage2Sample:
        cfg = self.cfg
        utt = self.utts[idx]
        audio, _ = read_wav(utt.audio_path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        audio = peak_normalize(audio, 0.95)
        code = utt.units.astype(np.int32)
        if abs(len(code) - 2 * utt.n_frames) > 2:
            raise ValueError(f"{utt.uid}: |code|={len(code)} vs 2x{utt.n_frames} frames")
        mel = np.load(utt.mel_path).astype(np.float32)
        code_len = min(len(audio) // cfg.code_hop_size, len(code))
        mel_len = min(len(audio) // cfg.mel_hop_size, len(mel))
        cut = min(mel_len * cfg.mel_hop_size, code_len * cfg.code_hop_size)
        return Stage2Sample(utt.uid, audio[:cut].astype(np.float32),
                            code[: cut // cfg.code_hop_size], mel[: cut // cfg.mel_hop_size],
                            np.load(utt.spk_emb_path).astype(np.float32))

    def _tile_to_segment(self, s: Stage2Sample) -> Stage2Sample:
        while len(s.audio) < self.cfg.segment_size:
            s = Stage2Sample(s.uid, np.concatenate([s.audio, s.audio]),
                             np.concatenate([s.code, s.code]), np.concatenate([s.mel, s.mel]),
                             s.spk_emb)
        return s

    def sample_segment(self, s: Stage2Sample) -> Stage2Sample:
        """A random segment that starts on a code boundary."""
        cfg = self.cfg
        s = self._tile_to_segment(s)
        n_codes = cfg.segment_size // cfg.code_hop_size
        start = int(self.rng.integers(0, len(s.code) - n_codes + 1))
        a0 = start * cfg.code_hop_size
        m0 = a0 // cfg.mel_hop_size
        return Stage2Sample(s.uid, s.audio[a0: a0 + cfg.segment_size],
                            s.code[start: start + n_codes],
                            s.mel[m0: m0 + cfg.segment_size // cfg.mel_hop_size], s.spk_emb)

    def collate(self, idxs: list[int]) -> dict:
        cfg = self.cfg
        samples = [self.load(i) for i in idxs]
        if self.train:
            samples = [self.sample_segment(s) for s in samples]
        n = min(len(s.audio) for s in samples)
        n -= n % cfg.code_hop_size
        audio = np.stack([s.audio[:n] for s in samples])
        code = np.stack([s.code[: n // cfg.code_hop_size] for s in samples])
        mel = np.stack([s.mel[: n // cfg.mel_hop_size] for s in samples])
        if self.train and self.mel_aug:
            mel = np.stack([mel_blur_noise(m, self.rng) for m in mel])
        spk = np.stack([s.spk_emb for s in samples])
        return {"audio": audio.astype(np.float32), "code": code.astype(np.int32),
                "mel": mel.astype(np.float32), "spk_emb": spk.astype(np.float32),
                "ids": [s.uid for s in samples]}

    def batches(self, batch_size: int, shuffle: bool = True):
        order = np.arange(len(self.utts))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield self.collate(list(order[i: i + batch_size]))
