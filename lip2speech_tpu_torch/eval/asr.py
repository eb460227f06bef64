"""ASR readback for evaluation and serving (reference: Whisper via
openai-whisper in test_compare.py / server.py:341; the port's copy of the
JAX package's eval/asr.py). Gated behind `transformers` with local weights:
with no model path, or weights that do not load, `try_load_asr` gives None
and the readback is skipped (the reference's degraded-startup pattern,
server.py:114-131)."""

from __future__ import annotations

import numpy as np


class WhisperASR:
    """transformers Whisper wrapper. Requires local model weights
    (zero-egress environments must pass a local path). Runs on the card
    unless device="cpu"."""

    def __init__(self, model_path: str = "openai/whisper-small",
                 language: str = "en", device=None):
        from transformers import WhisperForConditionalGeneration, WhisperProcessor

        from lip2speech_tpu_torch.pipeline.synthesise import resolve_device

        self.device = resolve_device(device)
        self.processor = WhisperProcessor.from_pretrained(model_path)
        self.model = WhisperForConditionalGeneration.from_pretrained(model_path)
        self.model.to(self.device).eval()
        self.language = language

    def run(self, wav: np.ndarray, sample_rate: int = 16_000) -> str:
        import torch

        inputs = self.processor(wav, sampling_rate=sample_rate,
                                return_tensors="pt").input_features.to(self.device)
        with torch.no_grad():
            ids = self.model.generate(inputs, language=self.language, task="transcribe")
        return self.processor.batch_decode(ids, skip_special_tokens=True)[0].strip()


def try_load_asr(model_path: str | None = None, device=None) -> "WhisperASR | None":
    if model_path is None:
        return None
    try:
        return WhisperASR(model_path, device=device)
    except Exception:
        return None
