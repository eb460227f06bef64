"""Faults planted in the port's timed path, to show that the comparison
catches them (benchmark/tests/test_benchmark_faults.py on the CPU, and
control.py on the card). Each is a hook of the drivers: `pipeline` hooks
take the built Lip2SpeechPipeline, `train_step` hooks wrap the step."""

from __future__ import annotations

import numpy as np


def altered_units(pipe):
    """Every served unit replaced by the next one."""
    import torch

    inner = pipe._forward

    def forward(model, vocoder, video, frames_mask, spk_emb):
        wav, units, mel, mask = inner(model, vocoder, video, frames_mask, spk_emb)
        return wav, torch.where(mask, (units + 1) % 200, units), mel, mask

    pipe._forward = forward


def altered_wav(pipe):
    """Every waveform 5% louder."""
    inner = pipe._forward

    def forward(model, vocoder, video, frames_mask, spk_emb):
        wav, units, mel, mask = inner(model, vocoder, video, frames_mask, spk_emb)
        return wav * 1.05, units, mel, mask

    pipe._forward = forward


def half_the_rows(pipe):
    """Rows past the first half of a call never computed: zeros."""
    inner = pipe._host_call

    def host_call(model, vocoder, dev, video, frames_mask, spk_emb):
        keep = max(1, len(video) // 2)
        wav, units, mel = inner(model, vocoder, dev, video[:keep], frames_mask[:keep],
                                spk_emb[:keep])

        def pad(a):
            return np.concatenate([a, np.zeros((len(video) - keep,) + a.shape[1:], a.dtype)])

        return pad(wav), pad(units), pad(mel)

    pipe._host_call = host_call


def state_unchanged(step):
    """An update that leaves the parameters as they were."""
    def bad(state, batch):
        real = state.optimizer.step
        state.optimizer.step = lambda *a, **k: None
        try:
            return step(state, batch)
        finally:
            state.optimizer.step = real
    return bad


def half_the_batch(step):
    """Each micro-batch's second half of rows left out; the loss is then the
    mean over the rest."""
    def bad(state, batch):
        half = batch["video"].shape[1] // 2
        return step(state, {k: v[:, :half] for k, v in batch.items()})
    return bad


PIPELINE = {f.__name__: f for f in (altered_units, altered_wav, half_the_rows)}
TRAIN_STEP = {f.__name__: f for f in (state_unchanged, half_the_batch)}
