"""Spectral-gating denoiser, the rnnoise-subprocess replacement (JAX
reference: ops/denoise.py).

The reference post-processes every synthesized waveform with
normalize -> rnnoise (C binary over a subprocess + ffmpeg resample chain)
-> normalize (helpers.py:386-416, config.py:55). This is an in-process
equivalent on the waveform's device: estimate a per-band noise floor from
the quietest frames, build a soft spectral gate, overlap-add resynthesis.
The JAX package takes its DFT as a matmul at the highest precision (XLA's
FFT loses digits on a TPU); here it is torch.fft.rfft / irfft, which give
the same transform: the DC and Nyquist bins of a real frame have no
imaginary part, so irfft's one-sided weights are the JAX inverse's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lip2speech_tpu_torch.ops.dsp import _cached

N_FFT = 512
HOP = 128


def spectral_gate(wav: torch.Tensor, strength: float = 1.5) -> torch.Tensor:
    """(T,) float32 -> denoised (T,) float32, on wav's device.

    Noise floor per band = 20th percentile of frame magnitudes (linear
    interpolation, as jnp.percentile); frames are attenuated by a soft
    Wiener-style mask clamped below by -26 dB.
    """
    wav = wav.float()
    t = wav.shape[0]
    win = _cached("hann", (N_FFT, True), wav.device, wav.dtype)
    pad = N_FFT // 2
    y = F.pad(wav[None, None], (pad, pad), mode="reflect")[0, 0]
    spec = torch.fft.rfft(y.unfold(0, N_FFT, HOP) * win, dim=-1)     # (F, bins)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-12)

    noise_floor = torch.quantile(mag, 0.2, dim=0)                    # (bins,)
    # power spectral subtraction with a -26 dB gain floor
    ratio = (strength * noise_floor[None, :] / torch.clamp(mag, min=1e-8)) ** 2
    gain = torch.sqrt(torch.clamp(1.0 - ratio, 0.0025, 1.0))
    rec = torch.fft.irfft(spec * gain, n=N_FFT, dim=-1) * win        # (F, N_FFT)

    # overlap-add with COLA normalization
    n_frames = rec.shape[0]
    idx = (torch.arange(n_frames, device=wav.device)[:, None] * HOP
           + torch.arange(N_FFT, device=wav.device)[None, :]).reshape(-1)
    total = t + 2 * pad
    out = wav.new_zeros(total).index_add_(0, idx, rec.reshape(-1))
    norm = wav.new_zeros(total).index_add_(0, idx, (win * win).repeat(n_frames))
    out = out / torch.clamp(norm, min=1e-8)
    return out[pad: pad + t]


def peak_normalize(wav: torch.Tensor, target: float = 0.95) -> torch.Tensor:
    """librosa.util.normalize(audio) * target (utils/audio_io.peak_normalize
    on the device)."""
    peak = wav.abs().max()
    return torch.where(peak == 0, wav, wav / peak * target)


def preprocess_audio(wav: torch.Tensor, strength: float = 1.5) -> torch.Tensor:
    """normalize -> denoise -> normalize (reference helpers.py:386-416), on
    wav's device."""
    return peak_normalize(spectral_gate(peak_normalize(wav.float()), strength))
