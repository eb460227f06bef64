"""The port's DSP (lip2speech_tpu_torch/ops/dsp.py) against the JAX package's
ops/dsp.py on the CPU, on synthetic signals (tones plus noise, odd and even
lengths): the constant builders exactly, the transforms by the tolerances
stated; the gradient of the HiFi-GAN mel, and the cache of constants."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import dsp as jdsp
from lip2speech_tpu_torch.ops import dsp as tdsp


def _signal(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    shape = (n,) if batch is None else (batch, n)
    tones = sum(a * np.sin(2 * np.pi * f * t + ph)
                for a, f, ph in ((0.4, 220.0, 0.1), (0.2, 1_310.0, 1.0), (0.1, 5_020.0, 2.0)))
    return (tones + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("win,periodic", [(640, True), (1024, True), (400, False), (7, True)])
def test_hann_window_exact(win, periodic):
    np.testing.assert_array_equal(tdsp.hann_window(win, periodic), jdsp.hann_window(win, periodic))
    if periodic:
        np.testing.assert_allclose(tdsp.hann_window(win), torch.hann_window(win).numpy(), atol=1e-6)


@pytest.mark.parametrize("sr,n_fft,mels,fmin,fmax", [
    (16_000, 640, 80, 0.0, 8000.0), (16_000, 1024, 80, 0.0, None), (22_050, 512, 40, 55.0, 7600.0)])
def test_mel_filterbank_exact(sr, n_fft, mels, fmin, fmax):
    got = tdsp.mel_filterbank(sr, n_fft, mels, fmin, fmax)
    assert got.shape == (mels, n_fft // 2 + 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jdsp.mel_filterbank(sr, n_fft, mels, fmin, fmax))


def test_frame_signal_matches_jax():
    y = np.arange(1_001, dtype=np.float32)
    got = tdsp.frame_signal(torch.from_numpy(y), 64, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdsp.frame_signal(jnp.asarray(y), 64, 16)))


@pytest.mark.parametrize("n,center,win", [(8_000, True, 640), (8_001, False, 1024), (4_321, True, 400)])
def test_stft_magnitude_matches_jax(n, center, win):
    """|STFT| relative to its largest bin, 2e-6: an FFT against a DFT
    matmul in f32. A window shorter than n_fft is centred in zeros."""
    n_fft, hop = (1024, 256) if not center else (640, 160)
    y = _signal(n, seed=n, batch=2)
    window = tdsp.hann_window(win)
    ref = np.asarray(jdsp.stft_magnitude(jnp.asarray(y), n_fft, hop, window, center, 1e-9))
    got = tdsp.stft_magnitude(torch.from_numpy(y), n_fft, hop, window, center, 1e-9).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-6 * ref.max())


@pytest.mark.parametrize("n", [8_960, 8_999, 16_000])
def test_log_mels_match_jax(n):
    """Log-mels at 5e-5 absolute, tighter than the 1e-4 asked of them (an
    FFT against a DFT matmul, then a log of f32 sums; read: up to 1.05e-5)."""
    y = _signal(n, seed=n, batch=3)
    ref = np.asarray(jdsp.mel_spectrogram_hifigan(jnp.asarray(y)))
    got = tdsp.mel_spectrogram_hifigan(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (3, (n + 2 * 384 - 1024) // 256 + 1, 80)
    np.testing.assert_allclose(got, ref, atol=5e-5)
    ref = np.asarray(jdsp.mel_spectrogram_dataset(jnp.asarray(y)))
    got = tdsp.mel_spectrogram_dataset(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (3, n // 160 + 1, 80)
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_dynamic_range_compression_matches_jax():
    x = np.array([0.0, 1e-7, 1e-5, 0.3, 12.0], np.float32)
    np.testing.assert_allclose(tdsp.dynamic_range_compression(torch.from_numpy(x)).numpy(),
                               np.asarray(jdsp.dynamic_range_compression(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("n", [16_000, 7_777, 300])
def test_logfbank_and_stacking_match_jax(n):
    """logfbank at 2e-5 absolute, tighter than the 1e-4 asked of it (read: up
    to 2.9e-6); a signal shorter than one frame gives one zero-padded frame.
    Stacking pads the tail with zero frames exactly."""
    y = _signal(n, seed=1)
    ref = np.asarray(jdsp.logfbank(jnp.asarray(y)))
    got = tdsp.logfbank(torch.from_numpy(y))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    stacked = tdsp.stack_audio_features(got, 4)
    assert stacked.shape == (-(-ref.shape[0] // 4), 4 * 26)
    ref_stacked = jdsp.stack_audio_features(jnp.asarray(got.numpy()), 4)
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(ref_stacked))


def test_logfbank_silence_takes_eps():
    got = tdsp.logfbank(torch.zeros(800))
    assert torch.equal(got, torch.full_like(got, float(np.log(np.finfo(np.float32).eps))))


def test_hifigan_mel_gradient_and_cached_constants():
    """The mel loss differentiates in the waveform (checked against finite
    differences in f64), and the window and filterbank are built once per
    (parameters, device, dtype)."""
    tdsp._cached.cache_clear()
    y = torch.from_numpy(_signal(2_048, seed=3)).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda w: tdsp.stft_magnitude(w, 256, 64, torch.hann_window(256, dtype=torch.float64),
                                      False, 1e-9).sum(), (y[:600],), eps=1e-6, atol=1e-5)
    y32 = y.detach().float().requires_grad_()
    for _ in range(3):
        tdsp.mel_spectrogram_hifigan(y32).mean().backward()
    assert torch.isfinite(y32.grad).all() and float(y32.grad.abs().max()) > 0
    info = tdsp._cached.cache_info()
    assert info.misses == 2 and info.hits == 4
