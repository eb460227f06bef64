"""Audio DSP: STFT, mel spectrograms, filterbanks (JAX reference:
ops/dsp.py).

Two log-mel variants:

* `mel_spectrogram_dataset`: Tacotron style, centred STFT (reflect pad
  n_fft//2), periodic Hann window, slaney mel, log(clamp(x, 1e-5)). The
  dataset mels and the stage-1 mel target.
* `mel_spectrogram_hifigan`: HiFi-GAN style, reflect pad (n_fft-hop)//2 on
  both sides, no centring, magnitude sqrt(re^2 + im^2 + 1e-9), slaney mel,
  log(clamp(x, 1e-5)). The vocoder's mel loss.

The JAX package takes its STFT as a DFT matmul at the highest precision,
because XLA's FFT loses digits on a TPU; here the transforms are
torch.stft / torch.fft.rfft (cuFFT on the card, pocketfft on the CPU).
Filterbanks and windows are built with numpy once and cached as tensors per
(parameters, device, dtype); do not modify the cached tensors. Everything
is differentiable in the waveform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

LOG_CLIP = 1e-5


# --------------------------------------------------------------------------
# numpy constant builders (copies of the JAX package's)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window; periodic matches torch.hann_window / scipy fftbins=True."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


def _hz_to_mel_slaney(f) -> np.ndarray:
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    mels = f / f_sp
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sample_rate: int, n_fft: int, num_mels: int, fmin: float,
                   fmax: float | None) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (num_mels, n_fft//2+1):
    librosa.filters.mel with htk=False, norm='slaney'."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (hz_pts[2: num_mels + 2] - hz_pts[:num_mels]))[:, None]
    return fb.astype(np.float32)


def htk_filterbank(sample_rate: int, n_fft: int, n_filters: int) -> np.ndarray:
    """python_speech_features' HTK mel bank (no norm), (n_filters, n_fft//2+1)."""
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)      # noqa: E731
    mel2hz = lambda m: 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)    # noqa: E731
    mel_pts = np.linspace(hz2mel(0), hz2mel(sample_rate / 2), n_filters + 2)
    bins = np.floor((n_fft + 1) * mel2hz(mel_pts) / sample_rate).astype(int)
    fb = np.zeros((n_filters, n_fft // 2 + 1), dtype=np.float32)
    for j in range(n_filters):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb


@functools.lru_cache(maxsize=32)
def _cached(kind: str, params: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    builders = {"hann": hann_window, "slaney": mel_filterbank, "htk": htk_filterbank}
    return torch.from_numpy(builders[kind](*params)).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# differentiable transforms


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., T) already padded -> (..., 1 + (T - n_fft) // hop, n_fft) (a view)."""
    return y.unfold(-1, n_fft, hop)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor | np.ndarray,
                   center: bool, mag_eps: float = 0.0) -> torch.Tensor:
    """|STFT| of (..., T) -> (..., n_frames, n_fft//2+1). center=True reflect-
    pads n_fft//2 on both sides, center=False (n_fft - hop)//2 (HiFi-GAN). A
    window shorter than n_fft is centred in zeros."""
    pad = n_fft // 2 if center else (n_fft - hop) // 2
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")[:, 0]
    win = torch.as_tensor(window, dtype=y.dtype, device=y.device)
    if win.shape[0] < n_fft:
        lpad = (n_fft - win.shape[0]) // 2
        win = F.pad(win, (lpad, n_fft - win.shape[0] - lpad))
    spec = torch.stft(y, n_fft, hop, n_fft, win, center=False, return_complex=True)
    power = spec.real.square() + spec.imag.square()
    return (power + mag_eps).sqrt().transpose(-1, -2).reshape(*lead, -1, n_fft // 2 + 1)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = LOG_CLIP) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


def _log_mel(y, sample_rate, n_fft, hop, win_length, num_mels, fmin, fmax, center, mag_eps):
    y = y.float()
    win = _cached("hann", (win_length, True), y.device, y.dtype)
    fb = _cached("slaney", (sample_rate, n_fft, num_mels, fmin, fmax), y.device, y.dtype)
    mag = stft_magnitude(y, n_fft, hop, win, center=center, mag_eps=mag_eps)
    return dynamic_range_compression(mag @ fb.T)


def mel_spectrogram_dataset(y: torch.Tensor, sample_rate: int = 16_000, n_fft: int = 640,
                            hop: int = 160, win_length: int = 640, num_mels: int = 80,
                            fmin: float = 0.0, fmax: float | None = 8000.0) -> torch.Tensor:
    """Tacotron-style log-mel, (..., T) -> (..., n_frames, num_mels)."""
    return _log_mel(y, sample_rate, n_fft, hop, win_length, num_mels, fmin, fmax, True, 0.0)


def mel_spectrogram_hifigan(y: torch.Tensor, sample_rate: int = 16_000, n_fft: int = 1024,
                            hop: int = 256, win_length: int = 1024, num_mels: int = 80,
                            fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """HiFi-GAN-style log-mel, (..., T) -> (..., n_frames, num_mels)."""
    return _log_mel(y, sample_rate, n_fft, hop, win_length, num_mels, fmin, fmax, False, 1e-9)


def logfbank(y: torch.Tensor, sample_rate: int = 16_000, win_len_s: float = 0.025,
             hop_s: float = 0.01, n_filters: int = 26, n_fft: int = 512,
             preemph: float = 0.97) -> torch.Tensor:
    """python_speech_features.logfbank: (T,) -> (n_frames, n_filters).
    Pre-emphasis, frames zero-padded at the tail, power spectrum / n_fft, HTK
    bank, log with float32 eps for zeros (the AV-HuBERT audio input)."""
    y = y.float()
    y = torch.cat([y[:1], y[1:] - preemph * y[:-1]])
    frame_len = int(round(win_len_s * sample_rate))
    frame_hop = int(round(hop_s * sample_rate))
    t = y.shape[-1]
    n_frames = 1 if t <= frame_len else 1 + int(np.ceil((t - frame_len) / frame_hop))
    y = F.pad(y, (0, (n_frames - 1) * frame_hop + frame_len - t))
    spec = torch.fft.rfft(frame_signal(y, frame_len, frame_hop), n=n_fft, dim=-1)
    power = (spec.real.square() + spec.imag.square()) / n_fft
    feat = power @ _cached("htk", (sample_rate, n_fft, n_filters), y.device, y.dtype).T
    return torch.log(torch.where(feat == 0, torch.finfo(torch.float32).eps, feat))


def stack_audio_features(feats: torch.Tensor, stack_order: int = 4) -> torch.Tensor:
    """(T, F) -> (ceil(T / s), F * s): consecutive frames stacked, zero-padded."""
    t, f = feats.shape
    target = -(-t // stack_order) * stack_order
    return F.pad(feats, (0, 0, 0, target - t)).reshape(target // stack_order, stack_order * f)
