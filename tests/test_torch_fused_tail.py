"""Port's resblock trio (lip2speech_tpu_torch/ops/fused_tail.py) against the
JAX package's fused Pallas kernel in interpret mode and its XLA reference.

The JAX kernel works on the folded (B, M, fold*C) layout; unfolding is a
reshape to (B, M*fold, C), then the port's (B, C, M*fold) conv layout."""

import re
from pathlib import Path

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
    """Both dtypes: among the even tiles from 32 that fit, the least waves x
    block cost. bf16: row-major buffers [rows + 16][C] plus the 48 KB weight
    ring, within 220 KB; f32: row-major [rows][C + 4] plus two slots of a
    [C][2048/C + 4] chunk in hi and lo, within 227 KB."""
    m, batch = 153_600, 4
    budget = tft.SMEM_BUDGET[dtype]
    tile = tft.tile_rows(c, dtype, 60, m, batch)
    assert tft.smem_bytes(c, dtype, tile, 60) <= budget
    assert tile % 2 == 0 and tile >= 32
    if dtype == torch.float32:
        assert tft.smem_bytes(c, dtype, tile, 60) == (2 * (tile + 120) * (c + 4) * 4
                                                      + 4 * c * (2048 // c + 4) * 4)
    else:
        assert tft.smem_bytes(c, dtype, tile, 60) == (tft.RING_STAGES * tft.RING_CHUNK
                                                      + 2 * (tile + 136) * c * 2)
    fits = [t for t in range(32, m + 1, 2) if tft.smem_bytes(c, dtype, t, 60) <= budget]
    assert tile + 2 not in fits or tft.smem_bytes(c, dtype, fits[-1] + 2, 60) > budget

    def cost(t):
        waves = -(-batch * -(-m // t) // 132)
        return waves * tft.block_cost(c, tft.conv_regions(KS, DILS, t), dtype)
    assert cost(tile) == min(cost(t) for t in fits)
    assert tft.tile_rows(c, dtype, 60, 40) <= 40        # never past the sequence


CU = Path(tft.__file__).resolve().parent.parent / "csrc" / "fused_tail.cu"


def _cxx(expr: str) -> str:
    """A constant expression of csrc/fused_tail.cu in Python (integer
    division; one ternary at most)."""
    expr = re.sub(r"\(size_t\)|Cfg<C>::", "", expr)
    expr = expr.replace("sizeof(bf16)", "2").replace("sizeof(float)", "4").replace("/", "//")
    m = re.fullmatch(r"(.+?)\s*\?\s*(.+?)\s*:\s*(.+)", expr)
    return f"({m[2]}) if ({m[1]}) else ({m[3]})" if m else expr


def _kernel_layout(path: str, c: int) -> dict:
    """The int constants of csrc/fused_tail.cu at C = c: the file's own and
    those of namespace `path` and its Cfg<C>; "smem" is its smem_bytes."""
    src = CU.read_text()
    body = src[src.index(f"namespace {path} {{"):src.index(f"}}  // namespace {path}")]
    shared = src[:src.index("namespace mma_path {")]
    env = {"C": c}
    for name, expr in re.findall(r"^\s*(?:static )?constexpr int (\w+) = ([^;]+);",
                                 shared + body, re.M):
        env[name] = eval(_cxx(expr), {}, env)
    ret = re.search(r"size_t smem_bytes\(int tile, int halo\) \{\s*return ([^;]+);", body)[1]
    env["smem"] = lambda tile, halo: eval(_cxx(ret), {}, {**env, "tile": tile, "halo": halo})
    return env


@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_tables_match_the_kernel_source(c, dtype):
    """tile_rows sizes the kernel's tiles from tables of its own: LAYOUTS
    (row warps, m16 tiles a warp holds per round, weight rows per chunk),
    smem_bytes and the ring and geometry sizes. They are the constants of
    csrc/fused_tail.cu's Cfg<C> and smem_bytes for each path, read from the
    source."""
    k = _kernel_layout("tf32_path" if dtype == torch.float32 else "mma_path", c)
    chunk = k["kKC"] if dtype == torch.float32 else k["kKR"]
    assert tft.LAYOUTS[dtype][c] == (k["kWM"], k["kMT"], chunk)
    for tile, halo in ((32, 60), (54, 60), (1000, 7)):
        assert tft.smem_bytes(c, dtype, tile, halo) == k["smem"](tile, halo)
    assert (tft.MAX_RES, tft.MAX_DIL) == (k["kMaxRes"], k["kMaxDil"])
    if dtype == torch.bfloat16:
        assert (tft.RING_STAGES, tft.RING_CHUNK) == (k["kStages"], k["kSlotBytes"])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,m", [(128, 7_680), (64, 15_360), (32, 30_720), (16, 61_440)])
def test_bf16_tiles_fill_the_card_at_batch_1(c, m, dtype):
    """A batch-1 x 96-frame request's stage gets at least 120 blocks on the
    H100's 132 SMs, and never more than one wave of them, in both dtypes
    (f32 is the server's default)."""
    tile = tft.tile_rows(c, dtype, 60, m, 1, 132)
    assert 120 <= -(-m // tile) <= 132


def test_kernel_launcher_rejects_cpu_tensors():
    _, tw = _weights(np.random.default_rng(0), 16)
    before = tft.fused_resblock_trio_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tft.fused_resblock_trio_kernel(torch.zeros(1, 16, 40), tw, KS, DILS)
    assert tft.fused_resblock_trio_kernel.launches == before


def _tf32(t):
    """cvt.rna.tf32.f32 on the f32 bits, as the kernel's split computes it:
    add half a TF32 ulp (0x1000), drop the 13 low bits (ties away from zero,
    as the sign is a separate bit)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tc(t):
    """An f32 register as the tensor core reads it for a TF32 product: the
    13 low bits dropped."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _conv_tf32(x, w, b, padding, dilation, terms):
    """One conv as csrc/fused_tail.cu's f32 path computes it: each operand
    split into hi = tf32(v) and lo = v - hi, which the tensor core reads
    truncated; terms 3 sums lo_x hi_w + hi_x lo_w + hi_x hi_w, terms 1 only
    hi_x hi_w. Every product of two TF32 values is exact in f32, so f32
    convs of the parts give the kernel's products; the bias is added
    after."""
    xh, wh = _tf32(x), _tf32(w)
    pairs = [(xh, wh)]
    if terms == 3:
        pairs = [(_tc(x - xh), wh), (xh, _tc(w - wh)), (xh, wh)]
    y = sum(torch.nn.functional.conv1d(a, bw, padding=padding, dilation=dilation)
            for a, bw in pairs)
    return y + b[None, :, None]


def _trio_tf32(x, weights, terms):
    """trio_plain with every conv replaced by _conv_tf32."""
    acc = None
    for rb, k, dils in zip(weights, KS, DILS):
        y = x
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            p1, p2 = tft.ops.branch_paddings(k, d)
            t = _conv_tf32(tft.ops.leaky_relu(y, tft.LRELU_SLOPE), w1, b1, p1, d, terms)
            y = y + _conv_tf32(tft.ops.leaky_relu(t, tft.LRELU_SLOPE), w2, b2, p2, 1, terms)
        acc = y if acc is None else acc + y
    return acc / len(weights)


def _rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_tf32_split_emulation_rounds_like_cvt_rna():
    """The emulation's rounding (as cvt.rna.tf32.f32 rounds, and as the
    kernel's split computes it) and that hi + lo recovers v to ~2^-21; the
    kernel itself is checked on the card."""
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12 - 2.0 ** -23])
    # TF32 keeps 10 mantissa bits: ties go away from zero, below a tie down
    assert _tf32(v).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                 -(1.0 + 2.0 ** -10), 1.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = _tf32(x)
    lo = _tc(x - hi)
    assert (_tc(hi) == hi).all() and (_tc(lo) == lo).all()
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("case", ["C128 K11 conv", "tiny trio"])
def test_3xtf32_holds_f32_accuracy_and_1xtf32_does_not(case):
    """The method, not the kernel: the f32 path's split (3xTF32), emulated
    in plain PyTorch, stays within 1e-5 of an f64 reference relative to max
    |ref|, where one TF32 product (1xTF32) does not. The kernel's own split
    is held on the card, where chip_smoke.py's f32 trio limit (TRIO_F32_TOL,
    2e-5 of max(1, |ref|) against the plain trio) passes 3xTF32 and fails
    1xTF32."""
    rng = np.random.default_rng(11)
    if case == "C128 K11 conv":
        c, k, d = 128, 11, 3
        x = torch.from_numpy(rng.standard_normal((1, c, 600)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
        pad = tft.ops.branch_paddings(k, d)[0]
        ref = torch.nn.functional.conv1d(x.double(), w.double(), b.double(), padding=pad,
                                         dilation=d)
        errs = {t: _rel_err(_conv_tf32(x, w, b, pad, d, t), ref) for t in (1, 3)}
    else:
        _, tw = _weights(rng, 16)
        x = torch.from_numpy(rng.standard_normal((2, 16, 300)).astype(np.float32) * 0.5)
        ref = tft.trio_plain(x.double(), [[tuple((w.double(), bb.double()) for w, bb in pair)
                                           for pair in rb] for rb in tw], KS, DILS)
        errs = {t: _rel_err(_trio_tf32(x, tw, t), ref) for t in (1, 3)}
    assert errs[3] <= 1e-5, errs
    assert errs[1] > 1e-5, errs
