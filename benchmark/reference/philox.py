"""Attention-dropout keep mask: element (i, j) of slice b*h is kept iff word
j % 4 of Philox4x32-10(counter (i, j // 4, b*h, 0), key = the 64-bit seed)
is at least uint32(rate * 2**32) (rate rounded to float32 first). The
attention kernels of the port draw the same bits on the card."""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    t0 = m * (x & 0xFFFF)
    t1 = m * (x >> 16)
    hi = (t1 + (t0 >> 16)) >> 16
    lo = (((t1 & 0xFFFF) << 16) + (t0 & _MASK32)) & _MASK32
    return hi, lo


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_mask(seed: int, rate: float, b: int, h: int, t: int, device=None) -> torch.Tensor:
    """(B, H, T, T) bool, True = kept."""
    if rate == 0.0:
        return torch.ones((b, h, t, t), dtype=torch.bool, device=device)
    t4 = (t + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    words = _philox(ar(t)[None, :, None], ar(t4)[None, None, :], ar(b * h)[:, None, None],
                    torch.zeros((), dtype=torch.int64, device=device), seed & _MASK32, seed >> 32)
    bits = torch.stack(torch.broadcast_tensors(*words), -1).reshape(b, h, t, 4 * t4)[..., :t]
    rate32 = float(torch.tensor(rate, dtype=torch.float32))
    return bits >= min(int(rate32 * 2 ** 32), 2 ** 32 - 1)
