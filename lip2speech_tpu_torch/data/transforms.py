"""Host-side data transforms (the port's own copy of the JAX package's
data/transforms.py; numpy only).

Video: scale to [0, 1], crop 88x88 (random in training, centred in eval),
horizontal flip p=0.5, RandomErase (p=0.5, scale 0.02-0.33, log-uniform
aspect 0.3-3.3), TimeMask (per 1 s hop, up to 0.4 s), then normalise with
mean 0.421 / std 0.165. Every random draw comes from the np.random.Generator
passed in, in the JAX package's order, so a seed gives the JAX package's
batches bit for bit. Also the noise mix and the vocoder-input mel corruption.
"""

from __future__ import annotations

import numpy as np

IMAGE_MEAN = 0.421
IMAGE_STD = 0.165

# the uint8 pixel whose dequantised value is closest to normalised 0.0
# (0.421 * 255 = 107.355): the erase, mask and pad fill of the uint8 wire format
UINT8_FILL = 107


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    t, h, w = frames.shape[:3]
    dh = int(round(h - size) / 2.0)
    dw = int(round(w - size) / 2.0)
    return frames[:, dh: dh + size, dw: dw + size]


def random_crop(frames: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    t, h, w = frames.shape[:3]
    dh = int(rng.integers(0, h - size + 1))
    dw = int(rng.integers(0, w - size + 1))
    return frames[:, dh: dh + size, dw: dw + size]


def horizontal_flip(frames: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    if rng.random() < p:
        return frames[:, :, ::-1]
    return frames


def random_erase(frames: np.ndarray, rng: np.random.Generator, p: float = 0.5,
                 scale=(0.02, 0.33), ratio=(0.3, 3.3), fill: float = 0.0) -> np.ndarray:
    """The reference's get_params returns (i, j, h, w) with h, w the FULL
    frame size, so the erase runs from (i, j) to the bottom-right corner;
    kept as it is."""
    if rng.random() >= p:
        return frames
    t, h, w = frames.shape
    area = h * w
    log_ratio = np.log(np.array(ratio))
    for _ in range(100):
        erase_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        eh = int(round(np.sqrt(erase_area * aspect)))
        ew = int(round(np.sqrt(erase_area / aspect)))
        if eh < h and ew < w:
            i = int(rng.integers(0, h - eh + 1))
            j = int(rng.integers(0, w - ew + 1))
            out = frames.copy()
            out[:, i:, j:] = fill
            return out
    return frames


def time_mask(frames: np.ndarray, rng: np.random.Generator, max_mask_s: float = 0.4,
              hop_s: float = 1.0, fps: int = 25, fill: float = 0.0) -> np.ndarray:
    max_mask = round(max_mask_s * fps)
    hop = round(hop_s * fps)
    out = frames.copy()
    for i in range(len(frames) // hop):
        mask_len = int(rng.integers(0, max_mask + 1))
        mask_start = int(rng.integers(0, hop - mask_len + 1))
        out[i * hop + mask_start: i * hop + mask_start + mask_len] = fill
    return out


def adaptive_time_mask(frames: np.ndarray, rng: np.random.Generator, window: int = 10,
                       stride: int = 25, mean_fill: bool = True) -> np.ndarray:
    """RAVEn's AdaptiveLengthTimeMask: one mask per `stride` frames of clip
    length, placed anywhere in the clip. As in the reference, each mask draws
    two values a, b ~ U[0, window): `a` bounds the start (a == 0 skips the
    mask) and `b` is the masked length, clamped at the clip's end. The fill
    is the clip's mean, or zero."""
    t = len(frames)
    n_mask = int((t + stride - 0.1) // stride)
    out = frames.copy()
    fill = frames.mean() if mean_fill else 0.0
    for _ in range(n_mask):
        a = int(rng.integers(0, window))
        b = int(rng.integers(0, window))
        if t - a <= 0:
            continue
        start = int(rng.integers(0, t - a))
        if a == 0:
            continue
        out[start: start + b] = fill
    return out


def prepare_video(frames_u8: np.ndarray, crop_size: int = 88, train: bool = False,
                  rng: np.random.Generator | None = None, use_random_erase: bool = False,
                  use_time_mask: bool = False, emit_uint8: bool = False) -> np.ndarray:
    """uint8 (T, H, W) -> normalised float32 (T, crop, crop). With emit_uint8
    the pixels stay uint8 (crop and flip only; erase and time mask fill with
    UINT8_FILL) and the train step dequantises them on the device."""
    if train and rng is None:
        raise ValueError("training transforms need an np.random.Generator")
    if emit_uint8:
        x = frames_u8
        if train:
            x = random_crop(x, crop_size, rng)
            x = horizontal_flip(x, rng)
            if use_random_erase:
                x = random_erase(x, rng, fill=UINT8_FILL)
            if use_time_mask:
                x = time_mask(x, rng, fill=UINT8_FILL)
        else:
            x = center_crop(x, crop_size)
        return np.ascontiguousarray(x.astype(np.uint8))
    x = frames_u8.astype(np.float32) / 255.0
    if train:
        x = random_crop(x, crop_size, rng)
        x = horizontal_flip(x, rng)
        x = (x - IMAGE_MEAN) / IMAGE_STD
        if use_random_erase:
            x = random_erase(x, rng)
        if use_time_mask:
            x = time_mask(x, rng)
    else:
        x = center_crop(x, crop_size)
        x = (x - IMAGE_MEAN) / IMAGE_STD
    return np.ascontiguousarray(x)


def mix_noise(wav: np.ndarray, noise: np.ndarray, snr_db: float,
              rng: np.random.Generator) -> np.ndarray:
    """Additive noise at a target SNR: the noise is tiled or cropped to the
    clip's length and scaled so that 10 log10(P_clean / P_noise) == snr_db."""
    n = len(wav)
    if len(noise) < n:
        noise = np.tile(noise, int(np.ceil(n / len(noise))))
    start = int(rng.integers(0, len(noise) - n + 1))
    noise = noise[start: start + n].astype(np.float64)
    p_clean = np.mean(wav.astype(np.float64) ** 2)
    p_noise = np.mean(noise ** 2)
    if p_noise <= 0:
        return wav
    scale = np.sqrt(p_clean / (p_noise * 10.0 ** (snr_db / 10.0)))
    return (wav + scale * noise).astype(np.float32)


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
