"""Host-side data transforms (the port's own copy of what stage 2 reads from
the JAX package's data/transforms.py). numpy only."""

from __future__ import annotations

import numpy as np


def mel_blur_noise(mel: np.ndarray, rng: np.random.Generator,
                   sigma_range=(0.1, 2.0), noise_std: float = 0.1) -> np.ndarray:
    """Vocoder-input mel corruption: a separable Gaussian blur of random
    sigma over (T, M), edge-padded, plus Gaussian noise."""
    sigma = rng.uniform(*sigma_range)
    radius = max(1, int(3 * sigma))
    xs = np.arange(-radius, radius + 1)
    kern = np.exp(-0.5 * (xs / sigma) ** 2)
    kern = (kern / kern.sum()).astype(np.float32)
    padded = np.pad(mel, ((radius, radius), (0, 0)), mode="edge")
    blurred = np.stack([np.convolve(padded[:, c], kern, mode="valid")
                        for c in range(mel.shape[1])], axis=1)
    padded2 = np.pad(blurred, ((0, 0), (radius, radius)), mode="edge")
    blurred2 = np.stack([np.convolve(padded2[r], kern, mode="valid")
                         for r in range(mel.shape[0])], axis=0)
    return blurred2 + rng.normal(0, noise_std, mel.shape).astype(np.float32)
