"""The attention kernels' dropout mask, recomputed with integer tensor ops.

csrc/philox.cuh draws the bits of element (i, j) of slice b*h from
Philox4x32-10 with key = the 64-bit seed and counter (i, j // 4, b*h, 0);
word j % 4 belongs to key j, and the element is kept iff
bits >= min(uint32(rate * 2**32), 2**32 - 1). This module computes the same
bits on any device (int64 tensors holding 32-bit words), so the plain versions
of the kernels can be held against them under the identical mask, and the CPU
path of training drops the same elements the card would for a given seed.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of m * x for 32-bit x held in int64; the
    product is split in two 48-bit halves so nothing overflows."""
    t0 = m * (x & 0xFFFF)
    t1 = m * (x >> 16)
    hi = (t1 + (t0 >> 16)) >> 16
    lo = (((t1 & 0xFFFF) << 16) + (t0 & _MASK32)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten rounds of Philox4x32 on int64 tensors of 32-bit words (broadcast
    against each other); returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """The kernels receive the rate as a float32, so the threshold is taken
    from the float32 nearest to `rate`."""
    rate32 = float(torch.tensor(rate, dtype=torch.float32))
    return min(int(rate32 * 2 ** 32), 2 ** 32 - 1)


def attention_keep_mask(seed: int, rate: float, b: int, h: int, t: int,
                        device=None) -> torch.Tensor:
    """(B, H, T, T) bool, True = kept, the mask the kernels apply for `seed`
    (0 <= seed < 2**64) at `rate`."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    if rate == 0.0:
        return torch.ones((b, h, t, t), dtype=torch.bool, device=device)
    t4 = (t + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    words = philox4x32_10(ar(t)[None, :, None], ar(t4)[None, None, :], ar(b * h)[:, None, None],
                          torch.zeros((), dtype=torch.int64, device=device),
                          seed & _MASK32, seed >> 32)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(b, h, t, 4 * t4)[..., :t]
    return bits >= dropout_threshold(rate)
