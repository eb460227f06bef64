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
    block cost. The weight ring (4 bf16 or 3 f32 slots of 16 KB), the
    residual buffer [tile + 120][C], the conv1 output buffer 10 rows
    shorter (no conv1 writes the outer 5 rows of either side), the
    barriers and the alignment slack, within the 227 KB a block may use."""
    m, batch = 153_600, 4
    es = 4 if dtype == torch.float32 else 2
    budget = tft.SMEM_LIMIT
    trim = tft.xt_trim(KS, DILS, 60)
    assert trim == 5
    tile = tft.tile_rows(c, dtype, 60, m, batch)
    assert tft.smem_bytes(c, dtype, tile, 60, trim) <= budget
    assert tile % 2 == 0 and tile >= 32
    assert tft.smem_bytes(c, dtype, tile, 60, trim) == (
        tft.ALIGN + tft.RING_STAGES[dtype] * tft.RING_SLOT + tft.BAR_BYTES
        + (2 * (tile + 120) - 10) * c * es)
    fits = [t for t in range(32, m + 1, 2) if tft.smem_bytes(c, dtype, t, 60, trim) <= budget]
    assert tile + 2 not in fits or tft.smem_bytes(c, dtype, fits[-1] + 2, 60, trim) > budget

    def cost(t):
        waves = -(-batch * -(-m // t) // 132)
        return waves * tft.block_cost(c, tft.conv_regions(KS, DILS, t), dtype)
    assert cost(tile) == min(cost(t) for t in fits)
    assert tft.tile_rows(c, dtype, 60, 40) <= 40        # never past the sequence


CU = Path(tft.__file__).resolve().parent.parent / "csrc" / "fused_tail.cu"


def _cxx(expr: str) -> str:
    """A constant expression of csrc/fused_tail.cu in Python: integer
    division, sizeof(T) as `es`, && and ||, and ternaries, nested or in
    parentheses, ! as not."""
    expr = " ".join(expr.split())
    while expr.startswith("("):
        depth = 0
        for i, ch in enumerate(expr):
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if depth == 0:
                break
        if i != len(expr) - 1:
            break
        expr = expr[1:-1].strip()
    depth, q = 0, -1
    for i, ch in enumerate(expr):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "?" and depth == 0:
            q = i
            break
    if q < 0:
        expr = re.sub(r"\(size_t\)|Cfg<T, C>::", "", expr).replace("sizeof(T)", "es")
        expr = expr.replace("/", "//").replace("&&", " and ").replace("||", " or ")
        return re.sub(r"!(?!=)", " not ", expr)
    depth = nest = 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth == 0 and ch == "?":
            nest += 1
        elif depth == 0 and ch == ":":
            if nest == 0:
                break
            nest -= 1
    return f"({_cxx(expr[q + 1:i])}) if ({_cxx(expr[:q])}) else ({_cxx(expr[i + 1:])})"


def _kernel_layout(dtype, c: int) -> dict:
    """The int constants of csrc/fused_tail.cu for one activation type at
    C = c: the file's own and those of its Cfg<T, C>; "smem" is its
    smem_bytes."""
    src = CU.read_text()
    top = src[:src.index("struct Cfg {")]
    cfg = src[src.index("struct Cfg {"):]
    cfg = cfg[:cfg.index("};")]
    env = {"C": c, "es": 4 if dtype == torch.float32 else 2}
    for name, expr in re.findall(r"^\s*(?:static )?constexpr (?:int|bool) (\w+) = ([^;]+);",
                                 top + cfg, re.M):
        env[name] = eval(_cxx(expr), {}, env)
    ret = re.search(r"size_t smem_bytes\(int tile, int halo, int trim\) \{\s*return ([^;]+);",
                    src)[1]
    env["smem"] = lambda tile, halo, trim: eval(
        _cxx(ret), {}, {**env, "tile": tile, "halo": halo, "trim": trim})
    return env


@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_tables_match_the_kernel_source(c, dtype):
    """tile_rows sizes the kernel's tiles and pack_weights lays out its
    weight stream from tables of their own: LAYOUTS (m64 tiles a consumer
    warpgroup holds a round, bytes of a weight panel row), _cfg, smem_bytes and the
    ring, barrier, warpgroup and geometry sizes. They are the constants of
    csrc/fused_tail.cu's Cfg<T, C> and smem_bytes, read from the source."""
    k = _kernel_layout(dtype, c)
    cfg = tft._cfg(c, dtype)
    assert tft.LAYOUTS[dtype][c] == (k["kMT"], k["kRB"])
    assert (cfg["e"], cfg["rb"], cfg["pw"], cfg["ks"], cfg["pps"], cfg["mt"]) == (
        k["kE"], k["kRB"], k["kPW"], k["kKS"], k["kPPS"], k["kMT"])
    assert (cfg["stack"], cfg["ns"]) == (k["kStack"], k["kNS"])
    for tile, halo, trim in ((32, 60, 5), (54, 60, 0), (1000, 7, 3)):
        assert tft.smem_bytes(c, dtype, tile, halo, trim) == k["smem"](tile, halo, trim)
    assert (tft.MAX_RES, tft.MAX_DIL) == (k["kMaxRes"], k["kMaxDil"])
    assert (tft.RING_SLOT, tft.BAR_BYTES, tft.ALIGN, tft.WARPGROUPS) == (
        k["kSlotBytes"], k["kBarBytes"], k["kAlign"], k["kConsumers"])
    assert tft.RING_STAGES[dtype] == k["kStages"]
    # the ring's barriers: full, empty and ready for each slot
    assert 3 * 8 * k["kStages"] <= k["kBarBytes"]


def test_conv_regions_shrink_by_each_conv_padding():
    """The rows each conv of the default trio computes for one 100-row tile
    (csrc/fused_tail.cu: conv_table): the k=11 chain needs 60 halo rows."""
    regions = tft.conv_regions(KS, DILS, 100)
    assert len(regions) == 18 and [k for k, _ in regions] == [3] * 6 + [7] * 6 + [11] * 6
    assert [r for _, r in regions[12:]] == [210, 200, 170, 160, 110, 100]
    assert [r for _, r in regions[:6]] == [122, 120, 114, 112, 102, 100]
    # bf16 C=128: 2 warpgroups x 2 m64 tiles a round, 11 x 128 / 16 = 88
    # k-steps a conv; 210 rows = 4 tiles, one round, two on the busiest
    # warpgroup
    assert tft.block_cost(128, [(11, 210)]) == 88 * 2
    assert tft.block_cost(128, [(11, 260)]) == 88 * (2 + 1)     # 5 tiles: two rounds
    # f32 C=128: 11 x 128 / 8 k-steps a conv
    assert tft.block_cost(128, [(11, 210)], torch.float32) == 176 * 2


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
    """One conv as csrc/fused_tail.cu's f32 path computes it: the
    activation split into hi = its register as the tensor core reads it
    (the 13 low bits dropped) and lo = x - hi, the weights (by the wrapper)
    into hi = tf32(w) and lo = w - hi, each part read truncated; terms 3
    sums lo_x hi_w + hi_x lo_w + hi_x hi_w, and at C = 16, where the
    kernel stacks hi_w and lo_w into one operand, lo_x lo_w as well; terms
    1 is tf32(x) tf32(w) alone (one TF32 product). Every product of two
    TF32 values is exact in f32, so f32 convs of the parts give the
    kernel's products; the bias is added after."""
    pairs = [(_tf32(x), _tf32(w))]
    if terms == 3:
        xh, wh = _tc(x), _tf32(w)
        xl, wl = _tc(x - xh), _tc(w - wh)
        pairs = [(xl, wh), (xh, wl), (xh, wh)] + ([(xl, wl)] if x.shape[1] == 16 else [])
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


def _stream_conv(x, packed, at, k, d, pad, c, dtype, lo_at=0):
    """One conv computed from the packed weight stream as the kernel walks
    it: from element `at` of `packed`, chunk by chunk (pack_weights' panels,
    RING_SLOT bytes at most, never across a conv), and in each chunk k-step
    by k-step: the k-step's weight columns (read back through the swizzle)
    against the input rows shifted by its tap, x (B, C_in, M) zero-padded.
    f32 in 3xTF32: the activation split as the kernel splits it (hi its
    register read truncated, lo = x - hi), the weights' hi and lo parts
    read from the stream, a stacked panel's second half or lo_at elements
    further on. Returns the conv's output without the bias and the element
    after the conv's part of the stream."""
    cfg = tft._cfg(c, dtype)
    e, pw, ks, pps, ns = (cfg[n] for n in ("e", "pw", "ks", "pps", "ns"))
    cpr = cfg["rb"] // 16
    n_panels = -(-k * c // pw)
    panel = ns * pw
    b, _, m = x.shape
    xp = torch.nn.functional.pad(x, (pad, pad))
    y = torch.zeros(b, c, m)
    r = torch.arange(ns).view(ns, 1)
    swz = r % 8 if cpr == 8 else (r // 2) % 4
    unswz = torch.arange(cpr).view(1, cpr) ^ swz                          # [row, chunk]
    for c0 in range(0, n_panels, pps):
        npan = min(pps, n_panels - c0)

        def chunk(start):
            slot = packed[start:start + npan * panel].float().view(npan, ns, cpr, e)
            # logical k-chunk u of row r sits in stored chunk u ^ swz(r)
            slot = slot.gather(2, unswz.view(1, ns, cpr, 1).expand(npan, ns, cpr, e))
            return slot.reshape(npan, ns, pw)
        wpanels = chunk(at + c0 * panel)
        if dtype == torch.float32 and cfg["stack"]:
            wh, wl = wpanels[:, :c], wpanels[:, c:]
        elif dtype == torch.float32:
            wh, wl = wpanels, chunk(lo_at + at + c0 * panel)
        for st in range((min((c0 + npan) * pw, k * c) - c0 * pw) // ks):
            kr = c0 * pw + st * ks
            tap, ci = kr // c, kr % c
            a = xp[:, ci:ci + ks, tap * d:tap * d + m]                      # (B, ks, M)
            cols = slice((st * ks) % pw, (st * ks) % pw + ks)
            p_ = st * ks // pw
            if dtype != torch.float32:
                y += torch.einsum("nk,bkm->bnm", wpanels[p_][:, cols], a)
                continue
            ah = _tc(a)
            al = _tc(a - ah)
            bh, bl = wh[p_][:, cols], _tc(wl[p_][:, cols])
            pairs = [(bh, al), (bl, ah), (bh, ah)]
            for wk, av in pairs:
                y += torch.einsum("nk,bkm->bnm", wk, av)
    return y, at + n_panels * panel


@pytest.mark.parametrize("c", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weight_stream_gives_each_conv(c, dtype):
    """The wrapper's weight packing (pack_weights: K-major 128- or 64-byte
    panels, swizzled, in ring chunks; f32 twice, split into hi and lo),
    walked as csrc/fused_tail.cu walks it: the
    trio with every conv computed from the stream, chunk by chunk and tap
    by tap against shifted rows, agrees with trio_plain (f64, the same
    weights in the kernel's dtype) within 1e-5 of max |ref|, and the stream
    holds exactly the 18 convs' panels. A wrong permutation, chunk order or
    swizzle is off by O(1). The method only: the kernel is held on the
    card."""
    rng = np.random.default_rng(c)
    _, tw = _weights(rng, c)
    tw = [[tuple((w.to(dtype).float(), bb.to(dtype).float()) for w, bb in pair) for pair in rb]
          for rb in tw]
    flat = [w for rb in tw for pair in rb for w, _ in pair]
    packed = tft.pack_weights(flat, c, dtype)
    assert packed.dtype == dtype
    cfg = tft._cfg(c, dtype)
    lo_at = packed.numel() // 2 if dtype == torch.float32 and not cfg["stack"] else 0
    if dtype == torch.float32:   # hi = v rounded to TF32 (as cvt.rna.tf32.f32 rounds), lo = v - hi
        rows = packed.view(-1, cfg["ns"] if cfg["stack"] else 1, cfg["pw"])
        hi, lo = ((rows[:, :c], rows[:, c:]) if cfg["stack"] else
                  (packed[:lo_at], packed[lo_at:]))
        assert (_tf32(hi) == hi).all()
        assert float((lo.abs() - hi.abs() * 2.0 ** -11).max()) <= 0.0
    x = torch.from_numpy(rng.standard_normal((1, c, 70)).astype(np.float32) * 0.5)
    at, acc = 0, None
    for rb, k, dils in zip(tw, KS, DILS):
        y = x
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            p1, p2 = tft.ops.branch_paddings(k, d)
            t, at = _stream_conv(tft.ops.leaky_relu(y, tft.LRELU_SLOPE), packed, at, k, d, p1,
                                 c, dtype, lo_at)
            t = t + b1[None, :, None]
            u, at = _stream_conv(tft.ops.leaky_relu(t, tft.LRELU_SLOPE), packed, at, k, 1, p2,
                                 c, dtype, lo_at)
            y = y + u + b2[None, :, None]
        acc = y if acc is None else acc + y
    got = acc / len(tw)
    assert at == packed.numel() - lo_at
    ref = tft.trio_plain(x.double(), [[tuple((w.double(), bb.double()) for w, bb in pair)
                                       for pair in rb] for rb in tw], KS, DILS)
    assert _rel_err(got, ref) <= 1e-5, _rel_err(got, ref)
