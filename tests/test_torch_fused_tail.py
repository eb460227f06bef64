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
    """f32: the largest multiple of 32 up to 1024 whose channel-major buffers
    fit. bf16: row-major buffers [rows + 16][C] plus the 32 KB weight ring;
    among the multiples of 16 that fit, the least waves x (tile + halo)."""
    m, batch = 153_600, 4
    tile = tft.tile_rows(c, dtype, 60, m, batch)
    assert tft.smem_bytes(c, dtype, tile, 60) <= tft.SMEM_BUDGET
    if dtype == torch.float32:
        assert tile % 32 == 0 and 32 <= tile <= 1024
        assert tile == 1024 or tft.smem_bytes(c, dtype, tile + 32, 60) > tft.SMEM_BUDGET
        assert tft.smem_bytes(c, dtype, tile, 60) == 2 * c * (tile + 120) * 4
        assert tft.tile_rows(c, dtype, 60, 40) == 64      # never past the sequence
        return
    assert tile % 2 == 0 and tile >= 32
    assert tft.smem_bytes(c, dtype, tile, 60) == (tft.RING_STAGES * tft.RING_CHUNK
                                                  + 2 * (tile + 136) * c * 2)
    fits = [t for t in range(32, m + 1, 2) if tft.smem_bytes(c, dtype, t, 60) <= tft.SMEM_BUDGET]
    assert tile + 2 not in fits or tft.smem_bytes(c, dtype, fits[-1] + 2, 60) > tft.SMEM_BUDGET

    def cost(t):
        waves = -(-batch * -(-m // t) // 132)
        return waves * tft.block_cost(c, tft.conv_regions(KS, DILS, t))
    assert cost(tile) == min(cost(t) for t in fits)
    assert tft.tile_rows(c, dtype, 60, 40) <= 40        # never past the sequence


def test_conv_regions_shrink_by_each_conv_padding():
    """The rows each conv of the default trio computes for one 100-row tile
    (csrc/fused_tail.cu: conv_table): the k=11 chain needs 60 halo rows."""
    regions = tft.conv_regions(KS, DILS, 100)
    assert len(regions) == 18 and [k for k, _ in regions] == [3] * 6 + [7] * 6 + [11] * 6
    assert [r for _, r in regions[12:]] == [210, 200, 170, 160, 110, 100]
    assert [r for _, r in regions[:6]] == [122, 120, 114, 112, 102, 100]
    # C=128: 8 row warps x 2 m16 tiles a round, 64 weight rows a chunk;
    # 210 rows = 14 tiles, one round, two tiles on the busiest warp
    assert tft.block_cost(128, [(11, 210)]) == 22 * 2
    assert tft.block_cost(128, [(11, 260)]) == 22 * (2 + 1)     # 17 tiles: two rounds


@pytest.mark.parametrize("c,m", [(128, 7_680), (64, 15_360), (32, 30_720), (16, 61_440)])
def test_bf16_tiles_fill_the_card_at_batch_1(c, m):
    """A batch-1 x 96-frame request's stage gets at least 120 blocks on the
    H100's 132 SMs, and never more than one wave of them."""
    tile = tft.tile_rows(c, torch.bfloat16, 60, m, 1, 132)
    assert 120 <= -(-m // tile) <= 132


def test_kernel_launcher_rejects_cpu_tensors():
    _, tw = _weights(np.random.default_rng(0), 16)
    before = tft.fused_resblock_trio_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tft.fused_resblock_trio_kernel(torch.zeros(1, 16, 40), tw, KS, DILS)
    assert tft.fused_resblock_trio_kernel.launches == before
