"""GE2E d-vector speaker encoder, the reference's speaker-embedding sidecar
brought in-process (JAX reference: models/speaker.py).

The reference calls an external Lip2Wav/Real-Time-Voice-Cloning HTTP service
returning a 256-d float32 d-vector (helpers.py:185-198, asserted shape/dtype
at :194). This is that model (Wan et al., "Generalized End-to-End Loss for
Speaker Verification"): 40-mel power spectrogram -> 3-layer LSTM(256) ->
Linear(256) + ReLU -> L2 normalize; utterance embedding = L2-normalized mean
over 1.6 s partial windows. The LSTM is torch's own (cuDNN's on the card),
so the published RTVC encoder.pt loads by its own names
(`convert_rtvc_encoder`); `convert/from_jax.speaker_state_dict` carries the
JAX package's parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lip2speech_tpu_torch.ops.dsp import _cached, stft_magnitude

MEL_N_FFT = 400
MEL_HOP = 160
MEL_CHANNELS = 40
PARTIAL_FRAMES = 160          # 1.6 s windows
EMBED_DIM = 256
LSTM_LAYERS = 3


def speaker_mel(wav: torch.Tensor, sample_rate: int = 16_000) -> torch.Tensor:
    """(T,) -> (frames, 40) POWER mel (librosa.feature.melspectrogram power=2,
    no log: the RTVC front-end convention), on wav's device."""
    wav = wav.float()
    fb = _cached("slaney", (sample_rate, MEL_N_FFT, MEL_CHANNELS, 0.0, sample_rate / 2),
                 wav.device, wav.dtype)
    win = _cached("hann", (MEL_N_FFT, True), wav.device, wav.dtype)
    mag = stft_magnitude(wav[None], MEL_N_FFT, MEL_HOP, win, center=True)[0]
    return mag.square() @ fb.T


class SpeakerEncoder(nn.Module):
    """(B, T, 40) mel frames -> (B, 256) L2-normalized d-vectors. Runs on the
    device of its parameters, which is the device of the inputs it is given."""

    def __init__(self, input_dim: int = MEL_CHANNELS, hidden: int = EMBED_DIM):
        super().__init__()
        self.lstm = nn.LSTM(input_dim, hidden, num_layers=LSTM_LAYERS, batch_first=True)
        self.linear = nn.Linear(hidden, EMBED_DIM)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        hs, _ = self.lstm(frames)
        e = torch.relu(self.linear(hs[:, -1]))
        return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-10)


def compute_partial_slices(n_frames: int, partial_frames: int = PARTIAL_FRAMES,
                           overlap: float = 0.5) -> list[slice]:
    """RTVC-style sliding partial windows (last window snapped to the end)."""
    if n_frames <= partial_frames:
        return [slice(0, n_frames)]
    step = max(int(round(partial_frames * (1 - overlap))), 1)
    slices = []
    start = 0
    while start + partial_frames <= n_frames:
        slices.append(slice(start, start + partial_frames))
        start += step
    if slices[-1].stop < n_frames:
        slices.append(slice(n_frames - partial_frames, n_frames))
    return slices


@torch.inference_mode()
def embed_utterance(encoder: SpeakerEncoder, wav: np.ndarray,
                    sample_rate: int = 16_000) -> np.ndarray:
    """wav -> 256-d float32 d-vector (the sidecar's contract,
    helpers.py:185-198), computed on the encoder's device. The partial
    windows all hold PARTIAL_FRAMES frames (or there is one, shorter), so
    they go through the LSTM as one batch."""
    dev = next(encoder.parameters()).device
    frames = speaker_mel(torch.as_tensor(np.asarray(wav, np.float32), device=dev), sample_rate)
    partials = torch.stack([frames[s] for s in compute_partial_slices(len(frames))])
    mean = encoder(partials).mean(dim=0)
    emb = mean / torch.clamp(torch.linalg.vector_norm(mean), min=1e-10)
    return emb.cpu().numpy().astype(np.float32)


def convert_rtvc_encoder(state_dict: dict) -> dict[str, torch.Tensor]:
    """RTVC encoder.pt ('lstm.weight_ih_l{k}' / 'linear.*', nn.LSTM's own
    names) -> SpeakerEncoder's state_dict; other keys (GE2E's similarity
    weight and bias) are left out, and a missing key raises KeyError."""
    names = [f"lstm.{kind}_l{layer}" for layer in range(LSTM_LAYERS)
             for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    return {k: torch.as_tensor(state_dict[k]).clone()
            for k in names + ["linear.weight", "linear.bias"]}
