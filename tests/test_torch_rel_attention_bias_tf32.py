"""The method of the f32 paths of csrc/rel_attention_bias.cu and
csrc/rel_attention_bias_bwd.cu, checked on the CPU: every product in 3xTF32
(each operand split into hi, rounded to TF32 as cvt.rna rounds, and lo =
v - hi, which the tensor core reads truncated to TF32; lo_a hi_b + hi_a
lo_b + hi_a hi_b in f32), the f32 bias added to the scores unrounded, the
scores in log2 units (acc * scale log2(e) + bias * log2(e), exp2), the
forward's two consumer warpgroups on alternate whole 64-key tiles with an
online softmax each, merged at the end in the kernel's order
(flash_fwd_hopper.cuh's bias variant), the backward's P = exp2(S - lse
log2(e)) from the same score and dq_u summed from the 64-key blocks'
partials (rel_attention_bias_bwd.cu's key-major pass), emulated in plain
PyTorch at the kernels' rounding points, against the JAX
package's f32 forward (`_dense_bias_attention_flat`) and its backward kernel
(`_flash_bias_bwd_impl` in interpret mode, from `_flash_bias_impl`'s
residuals), within the limits that chip_smoke.py holds the kernels to on the
card: 1e-4 absolute on valid rows forward (phase 7), 1e-4 of max(1, |ref|)
a gradient and DBIAS_TOL for dbias backward (phases 11 and 12). One TF32
product (1xTF32: hi_a hi_b), in every product or in any one of them, must
fall outside those limits, so that they tell the method from the cheaper
one. This checks the method, not the kernels, which run only on the card.
T = 128 (two key tiles of 64: the JAX backward kernel takes a block
multiple) with a ragged batch row and a fully masked one; head dim 64, the
kernels' only one."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import pallas_rel_attention as jra
from lip2speech_tpu_torch.ops import rel_attention as tra

FWD_TOL = 1e-4              # chip_smoke.py phase 7, f32, absolute
BWD_TOL = 1e-4              # chip_smoke.bwd_tolerance(f32), of max(1, |ref|)
DBIAS_TOL = {"max": 1e-5, "rms": 1e-4}   # chip_smoke.DBIAS_TOL
FWD_PRODUCTS = ("qk", "pv")
BWD_PRODUCTS = ("qk", "dpr", "dqu", "dk", "dv")
LENS = (128, 97, 0)
H, T, DK, BLK = 2, 128, 64, 64
SCALE = 1.0 / math.sqrt(DK)
LOG2E = 1.4426950408889634
MASKED2 = tra.NEG_INF * LOG2E   # a masked key's score in log2 units
TILE = 64                       # keys a tile of the forward, and a block of the backward


def _tf32(t):
    """cvt.rna.tf32.f32 on the f32 bits, as the kernels' split computes it."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tc(t):
    """An f32 register as the tensor core reads it for a TF32 product."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(eq, a, b, terms):
    """einsum of f32 operands at the kernels' rounding: terms 3 = lo_a hi_b +
    hi_a lo_b + hi_a hi_b (3xTF32), 1 = hi_a hi_b (1xTF32). Products of two
    TF32 values are exact in f32."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = torch.einsum(eq, _tc(a - ah), bh) + torch.einsum(eq, ah, _tc(b - bh)) + out
    return out


def _terms(products, one=None):
    """Every product in 3xTF32; `one` ("all" or a product's name) in 1xTF32."""
    return {name: 1 if one in ("all", name) else 3 for name in products}


def _scores2(q_u, k, bias, terms):
    """The scores in log2 units, acc * scale log2(e) + bias * log2(e) in f32:
    the bias is never rounded before it."""
    return _mm("bhqd,bhkd->bhqk", q_u, k, terms["qk"]) * (SCALE * LOG2E) + bias * LOG2E


def _merge(x, y):
    """The kernel's merge of two parts (max, sum, output) of the same rows."""
    (m0, l0, acc0), (m1, l1, acc1) = x, y
    m = torch.maximum(m0, m1)
    a, b = torch.exp2(m0 - m), torch.exp2(m1 - m)
    return m, l0 * a + l1 * b, acc0 * a + acc1 * b


def _forward(q_u, k, v, bias, mask, terms, streams=2):
    """The forward kernel's arithmetic: the scores in log2 units, masked keys
    at -1e30 log2(e); warpgroup c takes tiles c, c + streams, .. with its own
    running maximum m, P = exp2(S - m) split as the A of P V, the running sum
    from the unsplit P; the parts merged in order, then divided by the sum
    (streams=1: one online softmax over every tile in order)."""
    t = k.shape[-2]
    s = _scores2(q_u, k, bias, terms).masked_fill(~mask[:, None, None, :], MASKED2)
    merged = None
    for c in range(streams):
        m = torch.full(s.shape[:-1] + (1,), MASKED2)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q_u)
        for j0 in range(TILE * c, t, TILE * streams):
            st = s[..., j0:j0 + TILE]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(st - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _mm("bhqk,bhkd->bhqd", p, v[..., j0:j0 + TILE, :], terms["pv"])
            m = m_new
        merged = (m, l, acc) if merged is None else _merge(merged, (m, l, acc))
    m, l, acc = merged
    return acc / l.clamp_min(1e-20)


def _key_block_sums(ds, fn):
    """sum over the 64-key blocks of fn(dS with the other blocks' keys
    zeroed), in f32, as the key-major kernel adds its partials."""
    out = 0.0
    for j0 in range(0, ds.shape[-1], TILE):
        blk = torch.zeros_like(ds)
        blk[..., j0:j0 + TILE] = ds[..., j0:j0 + TILE]
        out = out + fn(blk)
    return out


def _backward(q_u, k, v, bias, mask, lse, out, g, terms):
    """The backward kernel's arithmetic (bias_attention_bwd_plain's
    formulas), each product at its rounding: the recomputed S in log2 units,
    P = exp2(S - lse log2(e)), dPr = dO V^T, dbias = P o (dPr - D) in f32,
    dQ_u = dS K summed over the 64-key blocks, dK = dS^T Q_u, dV = P^T dO
    with dS = dbias / sqrt(64)."""
    valid = mask[:, None, None, :] & (lse > tra.NEG_INF / 2)[..., None]
    prob = torch.where(valid, torch.exp2(_scores2(q_u, k, bias, terms) - lse[..., None] * LOG2E),
                       0.0)
    dpr = _mm("bhqd,bhkd->bhqk", g, v, terms["dpr"])
    dbias = prob * (dpr - (g * out).sum(-1, keepdim=True))
    ds = dbias * SCALE
    return (_key_block_sums(ds, lambda d: _mm("bhqk,bhkd->bhqd", d, k, terms["dqu"])),
            _mm("bhqk,bhqd->bhkd", ds, q_u, terms["dk"]),
            _mm("bhqk,bhqd->bhkd", prob, g, terms["dv"]), dbias)


@pytest.fixture(scope="module")
def case():
    """Inputs as chip_smoke.py makes them (randn; the bias built by the
    route's rel_position_bias from a randn q_v and position table), the JAX
    f32 forward, and the JAX backward kernel in interpret mode from its own
    forward's residuals."""
    rng = np.random.default_rng(11)
    b = len(LENS)
    q_u, q_v, k, v = (rng.standard_normal((b, H, T, DK)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((H, 2 * T - 1, DK)).astype(np.float32)
    bias = tra.rel_position_bias(torch.from_numpy(q_v), torch.from_numpy(p)).numpy()
    mask = np.arange(T)[None, :] < np.asarray(LENS)[:, None]
    g = rng.standard_normal((b, H, T, DK)).astype(np.float32) * mask[:, None, :, None]
    flat = lambda x: jnp.asarray(x.reshape(b * H, T, -1))  # noqa: E731
    maskf = jnp.asarray(np.repeat(mask.astype(np.int32), H, axis=0).reshape(b * H, 1, T))
    j = [flat(x) for x in (q_u, k, v, bias)]
    out_j, lse_j = jra._flash_bias_impl(*j, maskf, jnp.zeros((1,), jnp.int32), blk=BLK,
                                        interpret=True, return_lse=True)
    grads_j = jra._flash_bias_bwd_impl(*j, maskf, lse_j, out_j, flat(g), blk=BLK, interpret=True)
    unflat = lambda x, w=DK: torch.from_numpy(np.array(x)).reshape(b, H, T, w)  # noqa: E731
    return {"args": [torch.from_numpy(x) for x in (q_u, k, v, bias)],
            "mask": torch.from_numpy(mask), "g": torch.from_numpy(g),
            "lse": unflat(lse_j, 1)[..., 0], "out": unflat(out_j),
            "fwd_ref": unflat(jra._dense_bias_attention_flat(*j, maskf)),
            "bwd_ref": [unflat(x) for x in grads_j[:3]] + [unflat(grads_j[3], T)]}


def _fwd_err(case, terms, streams=2):
    """Max abs error over the valid rows (a fully masked row is a uniform
    average in the kernel and 0 in the dense reference)."""
    got = _forward(*case["args"], case["mask"], terms, streams)
    rows = case["mask"][:, None, :, None]
    return float(((got - case["fwd_ref"]) * rows).abs().max())


def _bwd_errs(case, terms):
    """The largest gradient error over max(1, |ref|), and dbias's max error
    over max(1, |ref|) and RMS error over the RMS of ref (chip_smoke's
    dbias_errs)."""
    got = _backward(*case["args"], case["mask"], case["lse"], case["out"], case["g"], terms)
    grads = max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
                for a, r in zip(got[:3], case["bwd_ref"][:3]))
    d, ref = got[3] - case["bwd_ref"][3], case["bwd_ref"][3]
    return grads, {"max": float(d.abs().max()) / max(1.0, float(ref.abs().max())),
                   "rms": float(d.square().mean().sqrt() / ref.square().mean().sqrt())}


def _bwd_within(grads, dbias, scale=1.0):
    return grads <= BWD_TOL * scale and all(dbias[k] <= DBIAS_TOL[k] * scale for k in DBIAS_TOL)


def test_3xtf32_forward_is_within_the_f32_limit(case):
    assert _fwd_err(case, _terms(FWD_PRODUCTS)) <= FWD_TOL / 10


def test_3xtf32_backward_is_within_the_f32_limits(case):
    assert _bwd_within(*_bwd_errs(case, _terms(BWD_PRODUCTS)), scale=0.1)


@pytest.mark.parametrize("one", ("all",) + FWD_PRODUCTS)
def test_one_tf32_product_fails_the_forward_limit(case, one):
    assert _fwd_err(case, _terms(FWD_PRODUCTS, one)) > FWD_TOL


@pytest.mark.parametrize("one", ("all",) + BWD_PRODUCTS)
def test_one_tf32_product_fails_the_backward_limits(case, one):
    assert not _bwd_within(*_bwd_errs(case, _terms(BWD_PRODUCTS, one)))


def test_warpgroup_combine_is_within_the_f32_limit(case):
    """The forward's two warpgroups over alternate whole 64-key tiles,
    combined at the end, against one online softmax over every tile in
    order: the order of the sums only, far inside the limit; both within it
    of the JAX forward."""
    args = (*case["args"], case["mask"], _terms(FWD_PRODUCTS))
    rows = case["mask"][:, None, :, None]
    diff = (_forward(*args) - _forward(*args, streams=1)) * rows
    assert float(diff.abs().max()) <= FWD_TOL / 100
    assert _fwd_err(case, _terms(FWD_PRODUCTS), streams=1) <= FWD_TOL / 10


@pytest.mark.parametrize("t", [130, 235])   # a ragged last tile; odd T, each warpgroup two tiles
def test_3xtf32_forward_at_ragged_t_is_within_the_f32_limit(t):
    """The forward's method at T not a multiple of 64 (the JAX backward
    kernel takes only block multiples, the dense forward any T), with a
    ragged batch row and a fully masked one; one TF32 product fails."""
    rng = np.random.default_rng(t)
    lens = (t, round(0.83 * t), 0)
    b = len(lens)
    q_u, q_v, k, v = (rng.standard_normal((b, H, t, DK)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((H, 2 * t - 1, DK)).astype(np.float32)
    bias = tra.rel_position_bias(torch.from_numpy(q_v), torch.from_numpy(p))
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    flat = lambda x: jnp.asarray(x.reshape(b * H, t, -1))  # noqa: E731
    maskf = jnp.asarray(np.repeat(mask.astype(np.int32), H, axis=0).reshape(b * H, 1, t))
    ref = torch.from_numpy(np.array(jra._dense_bias_attention_flat(
        flat(q_u), flat(k), flat(v), flat(bias.numpy()), maskf))).reshape(b, H, t, DK)
    args = [torch.from_numpy(x) for x in (q_u, k, v)]
    rows = torch.from_numpy(mask)[:, None, :, None]
    err = lambda terms: float(((_forward(*args[:2], args[2], bias, torch.from_numpy(mask), terms)  # noqa: E731
                                - ref) * rows).abs().max())
    assert err(_terms(FWD_PRODUCTS)) <= FWD_TOL / 10
    assert err(_terms(FWD_PRODUCTS, "all")) > FWD_TOL
