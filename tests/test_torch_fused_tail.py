"""Port's resblock trio (lip2speech_tpu_torch/ops/fused_tail.py) against the
JAX package's fused Pallas kernel in interpret mode and its XLA reference.

The JAX kernel works on the folded (B, M, fold*C) layout; unfolding is a
reshape to (B, M*fold, C), then the port's (B, C, M*fold) conv layout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops.pallas_fused_tail import fused_resblock_trio, trio_xla
from lip2speech_tpu_torch.ops import fused_tail as tft

KS = (3, 7, 11)
DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def _weights(rng, c):
    """JAX-layout (K, C, C) weights and the same weights in torch layout."""
    jw, tw = [], []
    for k, ds in zip(KS, DILS):
        jrb, trb = [], []
        for _ in ds:
            pair = [(rng.standard_normal((k, c, c)).astype(np.float32) * 0.1,
                     rng.standard_normal(c).astype(np.float32) * 0.1) for _ in range(2)]
            jrb.append(tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pair))
            trb.append(tuple((torch.from_numpy(w.transpose(2, 1, 0).copy()),
                              torch.from_numpy(b)) for w, b in pair))
        jw.append(jrb)
        tw.append(trb)
    return jw, tw


def _to_port(xf, fold):
    b, m, lanes = xf.shape
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(xf).reshape(b, m * fold, lanes // fold).transpose(0, 2, 1)))


@pytest.mark.parametrize("c,fold", [(16, 8), (32, 4)])
def test_trio_plain_matches_jax_fused_kernel(c, fold):
    rng = np.random.default_rng(c)
    jw, tw = _weights(rng, c)
    xf = jnp.asarray(rng.standard_normal((2, 12, fold * c)) * 0.5, jnp.float32)
    ref_kernel = fused_resblock_trio(xf, jw, fold, KS, DILS, interpret=True,
                                     block_rows=8)
    ref_xla = trio_xla(xf, jw, fold, KS, DILS)
    got = tft.fused_resblock_trio(_to_port(xf, fold), tw, KS, DILS).numpy()
    for ref in (ref_kernel, ref_xla):
        np.testing.assert_allclose(got, _to_port(ref, fold).numpy(), rtol=2e-5, atol=2e-6)


def test_geometry_halo_from_branch_paddings():
    geom, halo = tft._geometry(KS, DILS)
    # k=11: (5+5) + (15+5) + (25+5)
    assert halo == 60 and geom[:3] == [3, 3, 60]
    assert geom[3:3 + tft.MAX_RES] == [3, 7, 11, 0]


@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_rows_fit_shared_memory(c, dtype):
    tile = tft.tile_rows(c, dtype, 60, 153_600)
    assert tile % 32 == 0 and 32 <= tile <= 1024
    assert tft.smem_bytes(c, dtype, tile, 60) <= tft.SMEM_BUDGET
    assert tile == 1024 or tft.smem_bytes(c, dtype, tile + 32, 60) > tft.SMEM_BUDGET
    assert tft.tile_rows(c, dtype, 60, 40) == 64      # never past the sequence


def test_kernel_launcher_rejects_cpu_tensors():
    _, tw = _weights(np.random.default_rng(0), 16)
    before = tft.fused_resblock_trio_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tft.fused_resblock_trio_kernel(torch.zeros(1, 16, 40), tw, KS, DILS)
    assert tft.fused_resblock_trio_kernel.launches == before
