"""Manifest and label file IO (the port's own copy of the JAX package's
data/manifest.py).

  * TSV manifest: first line = dataset root; then per-utterance rows
      id \\t video_rel_path \\t audio_rel_path \\t n_video_frames \\t n_audio_samples
  * .unt: one line per utterance, space-separated unit ids (0..199), parallel
    to the TSV rows
  * dict.unt.txt: "symbol count" per line; fairseq's Dictionary order gives
    token ids bos=0, pad=1, eos=2, unk=3, then the symbols in file order (unit
    k is token k + 4)
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from lip2speech_tpu_torch.core.config import UnitConfig


@dataclass
class Utterance:
    uid: str
    video_path: Path
    audio_path: Path
    n_frames: int
    n_samples: int
    units: np.ndarray | None = None          # raw unit ids 0..199

    @property
    def mel_path(self) -> Path:
        """The mel sits in a parallel tree: /video/ -> /mel/, suffix -> .npy."""
        p = str(self.video_path)
        return Path(p.replace("/video/", "/mel/")[: -len(self.video_path.suffix)] + ".npy")

    @property
    def spk_emb_path(self) -> Path:
        p = str(self.video_path)
        return Path(p.replace("/video/", "/spk_emb/")[: -len(self.video_path.suffix)] + ".npy")


def read_manifest(tsv_path: str | Path, unt_path: str | Path | None = None,
                  root_override: str | Path | None = None) -> list[Utterance]:
    tsv_path = Path(tsv_path)
    lines = tsv_path.read_text().strip().split("\n")
    root = Path(root_override) if root_override is not None else Path(lines[0].strip())
    utts = []
    for line in lines[1:]:
        uid, video, audio, n_frames, n_samples = line.rstrip("\n").split("\t")[:5]
        utts.append(Utterance(uid=uid, video_path=root / video, audio_path=root / audio,
                              n_frames=int(n_frames), n_samples=int(n_samples)))
    if unt_path is not None:
        unit_lines = Path(unt_path).read_text().strip().split("\n")
        if len(unit_lines) != len(utts):
            raise ValueError(
                f"{unt_path}: {len(unit_lines)} label rows vs {len(utts)} manifest rows")
        for utt, ul in zip(utts, unit_lines):
            utt.units = np.array([int(u) for u in ul.split()], dtype=np.int32)
    return utts


def write_units(unt_path: str | Path, unit_rows: list[np.ndarray]) -> None:
    Path(unt_path).parent.mkdir(parents=True, exist_ok=True)
    Path(unt_path).write_text(
        "\n".join(" ".join(str(int(u)) for u in row) for row in unit_rows) + "\n")


def write_manifest(tsv_path: str | Path, root: str | Path, utts: list[Utterance]) -> None:
    tsv_path = Path(tsv_path)
    tsv_path.parent.mkdir(parents=True, exist_ok=True)
    rows = [str(root)]
    rootp = Path(root)
    for u in utts:
        video, audio = Path(u.video_path), Path(u.audio_path)
        if video.is_absolute():
            video = video.relative_to(rootp)
        if audio.is_absolute():
            audio = audio.relative_to(rootp)
        rows.append(f"{u.uid}\t{video}\t{audio}\t{u.n_frames}\t{u.n_samples}")
    tsv_path.write_text("\n".join(rows) + "\n")


def write_unit_dictionary(path: str | Path, num_units: int = 200) -> None:
    """dict.unt.txt with dummy counts, as the reference's."""
    Path(path).write_text("\n".join(f"{i} 1" for i in range(num_units)) + "\n")


def units_to_tokens(units: np.ndarray, cfg: UnitConfig = UnitConfig(),
                    append_eos: bool = True) -> np.ndarray:
    """Raw units (0..199) -> fairseq token ids (+num_special), optional EOS."""
    toks = units.astype(np.int64) + cfg.num_special
    if append_eos:
        toks = np.concatenate([toks, [cfg.eos]])
    return toks


def tokens_to_units(tokens: np.ndarray, cfg: UnitConfig = UnitConfig()) -> np.ndarray:
    """Token ids -> raw units, dropping the specials."""
    toks = np.asarray(tokens)
    return (toks[toks >= cfg.num_special] - cfg.num_special).astype(np.int32)
