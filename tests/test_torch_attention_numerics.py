"""The rounding points of the bf16 tensor-core masked attention kernel
(lip2speech_tpu_torch/csrc/attention.cu, dtype 1: the forward of
flash_fwd_hopper.cuh), emulated in plain PyTorch on the CPU, against the f32
plain version of lip2speech_tpu_torch/ops/attention.py.

The kernel takes bf16 q, k, v and accumulates both products in f32. A block
of 128 query rows has two consumer warpgroups; warpgroup c takes rows 64c ..
64c+63 against every key of each 64-key tile, with one online softmax per
row in log2 units (the scores times scale * log2(e), exp2). Where it
rounds: the probabilities exp2(S - m) of each 64-key tile, at the row's
running maximum m after that tile, to bf16 before P V; the running sum
stays f32 (from the unrounded probabilities); the output to bf16. Masked
keys score -1e30 (times log2(e)), so a batch row with no valid key gets a
uniform average of V, as the plain version's -1e9. The emulation repeats
exactly that (test-local: the package gains no code path). The assertion
uses the tolerance the kernel is held to on the card: 2e-2, on every row
(the fully masked one included).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import pallas_attention as jatt
from lip2speech_tpu_torch.ops import attention as tatt

TOL = 2e-2
TILE = 64                    # keys per tile of the kernel's loop
MASKED = -1e30
LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _inputs(t, seed, b=2, h=16, dk=64):
    """bf16-valued q, k, v as f32 tensors and the key mask: batch row 0
    ragged, row 1 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal((b, h, t, dk)).astype(np.float32)))
               for _ in range(3))
    lens = [round(0.83 * t), 0]
    mask = torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
    return q, k, v, mask, lens


def _emulate(q, k, v, mask):
    """attention.cu's bf16 kernel: one online softmax a row in log2 units
    over whole 64-key tiles."""
    t = k.shape[-2]
    s = (q @ k.transpose(-1, -2)) * (LOG2E / math.sqrt(q.shape[-1]))
    s = s.masked_fill(~mask[:, None, None, :], MASKED * LOG2E)
    m = torch.full(s.shape[:-1] + (1,), MASKED * LOG2E)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for j0 in range(0, t, TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        pt = torch.exp2(st - m_new)
        l = l * alpha + pt.sum(-1, keepdim=True)
        acc = acc * alpha + _bf16(pt) @ v[..., j0:j0 + TILE, :]
        m = m_new
    return _bf16(acc / l.clamp_min(1e-20))


@pytest.mark.parametrize("t", [50, 96, 235, 240, 600])   # one tile (a half past T), the flagship's
# f32 request, a ragged tile, the serving T, the train step's T
def test_bf16_rounding_points_fit_the_kernel_tolerance(t):
    q, k, v, mask, lens = _inputs(t, seed=t)
    ref = tatt.reference_attention(q, k, v, mask)             # f32 plain version
    ref_j = np.asarray(jatt.reference_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v, mask))))
    n = lens[0]
    np.testing.assert_allclose(ref_j[0, :, :n], ref[0, :, :n].numpy(), atol=2e-5)

    out = _emulate(q, k, v, mask)
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())                      # every row, the empty one too
    assert err <= TOL, err
    # the fully masked row is the uniform average of V over the sequence
    uniform = v[1].mean(dim=1, keepdim=True).expand_as(v[1])
    assert float((out[1] - uniform).abs().max()) <= TOL


def test_bf16_rounding_without_mask_matches_jax_flash():
    """Unit extraction's call (no mask) at a T that is not a tile multiple."""
    q, k, v, _, _ = _inputs(149, seed=5, b=1, h=12)
    ones = torch.ones(1, 149, dtype=torch.bool)
    ref = np.asarray(jatt.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v, ones)),
                                          block_q=32, block_k=32, interpret=True))
    out = _emulate(q, k, v, ones)
    assert float(np.abs(out.numpy() - ref).max()) <= TOL
