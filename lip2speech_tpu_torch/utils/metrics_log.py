"""Training metrics log (the port's own copy of the JAX package's
utils/metrics_log.py): scalars stream to a JSONL file, validation audio
snapshots are written as WAVs and mels as .npy, with a PNG figure where
matplotlib is installed."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from lip2speech_tpu_torch.utils.audio_io import write_wav


class MetricsLogger:
    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.logdir / "scalars.jsonl", "a")

    def scalars(self, step: int, **values) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def audio(self, step: int, name: str, wav: np.ndarray, sample_rate: int = 16_000) -> None:
        write_wav(self.logdir / "audio" / f"{name}_{step:08d}.wav", np.asarray(wav), sample_rate)

    def mel(self, step: int, name: str, mel: np.ndarray, figure: bool = True) -> None:
        path = self.logdir / "mel" / f"{name}_{step:08d}.npy"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, np.asarray(mel))
        if figure:
            self.mel_figure(step, name, mel)

    def mel_figure(self, step: int, name: str, mel: np.ndarray) -> None:
        """A PNG spectrogram figure; nothing without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        path = self.logdir / "fig" / f"{name}_{step:08d}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(np.asarray(mel).T, aspect="auto", origin="lower", interpolation="none")
        fig.colorbar(im, ax=ax)
        fig.savefig(path, bbox_inches="tight", dpi=80)
        plt.close(fig)

    def close(self) -> None:
        self._f.close()


def read_scalars(logdir: str | Path) -> list[dict]:
    path = Path(logdir) / "scalars.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().strip().splitlines()]
