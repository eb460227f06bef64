"""The method of the f32 paths of csrc/rel_attention.cu and
csrc/rel_attention_bwd.cu, checked on the CPU: every product in 3xTF32
(each operand split into hi, rounded to TF32 as cvt.rna rounds, and lo =
v - hi, which the tensor core reads truncated to TF32; lo_a hi_b + hi_a
lo_b + hi_a hi_b in f32; on wgmma or mma.sync alike, the split done once a
tile for a shared-memory operand and at the fragment for a register one,
the same values either way), emulated in plain PyTorch at the kernels'
rounding points (the forward's online softmax as flash_fwd_hopper.cuh runs
it: a block's two consumer warpgroups take keys 32c .. 32c+31 of every
64-key tile, each with its own running maximum and sum in log2 units, exp2
of the scores times scale * log2(e), combined at the end), against the JAX package's f32 forward (`dense_rel_attention`)
and backward (`_rel_flash_bwd_impl` in interpret mode), within the limits
that chip_smoke.py holds the kernels to on the card: 1e-4 absolute forward
(phase 3), 1e-4 of max(1, |ref|) a gradient backward (phases 11 and 12).
One TF32 product (1xTF32: hi_a hi_b), in every product or in any one of
them, must fall outside those limits, so that they tell the method from
the cheaper one. The backward kernel is key-major: a block owns 64 keys,
so dq_u, dq_v and dp are f32 sums of the blocks' partials, and it takes P
as exp2(S * scale * log2(e) - lse * log2(e)) from the unscaled S; the
emulation does the same. This checks the method, not the kernels, which
run only on the card. T = 130 (three key tiles of 64, the last one ragged)
with a fully masked batch row; head dim 64, the kernels' only one."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import pallas_rel_attention as jra
from lip2speech_tpu_torch.ops import rel_attention as tra

FWD_TOL = 1e-4              # chip_smoke.py phase 3, absolute
BWD_TOL = 1e-4              # chip_smoke.bwd_tolerance(f32), of max(1, |ref|)
FWD_PRODUCTS = ("qk", "pos", "pv")
BWD_PRODUCTS = ("qk", "pos", "dpr", "dqu", "dqv", "dk", "dv", "dp")
LENS = (130, 97, 0)
H, T, DK = 2, 130, 64
KEY_BLOCK = 64              # keys a block of the backward kernel owns
TILE = 64                   # keys per step of the forward's loop
HALF = 32                   # keys of a tile each of the forward's consumer warpgroups takes
LOG2E = 1.4426950408889634


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


def _scores(q_u, q_v, k, p, terms):
    return (_mm("bhqd,bhkd->bhqk", q_u, k, terms["qk"])
            + tra.rel_shift(_mm("bhqd,hpd->bhqp", q_v, p, terms["pos"]))) / math.sqrt(DK)


def _forward(q_u, q_v, k, v, p, mask, terms, halves=2):
    """The forward kernel's arithmetic: S in f32 from the split products,
    times log2(e), masked keys at -1e30 log2(e); per warpgroup and key tile
    the running maximum m of its 32 keys, P = exp2(S - m) split as the A of
    P V, the running sum from the unsplit P; then the warpgroups combined
    (halves=1: one online softmax over whole 64-key tiles)."""
    masked2 = tra.NEG_INF * LOG2E
    s = (_scores(q_u, q_v, k, p, terms) * LOG2E).masked_fill(~mask[:, None, None, :], masked2)
    width = TILE // halves
    m_all, l_all, acc_all = [], [], []
    for c in range(halves):
        m = torch.full(s.shape[:-1] + (1,), masked2)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q_u)
        for j0 in range(width * c, T, TILE):
            st = s[..., j0:j0 + width]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            e = torch.exp2(st - m_new)
            l = l * alpha + e.sum(-1, keepdim=True)
            acc = acc * alpha + _mm("bhqk,bhkd->bhqd", e, v[..., j0:j0 + width, :], terms["pv"])
            m = m_new
        m_all.append(m)
        l_all.append(l)
        acc_all.append(acc)
    m = torch.stack(m_all).amax(0)
    scales = [torch.exp2(x - m) for x in m_all]
    l = sum(x * a for x, a in zip(l_all, scales))
    return sum(x * a for x, a in zip(acc_all, scales)) / l.clamp_min(1e-20)


def _block_sums(ds, fn):
    """sum over the key blocks of fn(dS with the other blocks' keys zeroed),
    in f32: what the key-major kernel adds into its f32 buffers."""
    out = 0.0
    for j0 in range(0, ds.shape[-1], KEY_BLOCK):
        blk = torch.zeros_like(ds)
        blk[..., j0:j0 + KEY_BLOCK] = ds[..., j0:j0 + KEY_BLOCK]
        out = out + fn(blk)
    return out


def _backward(q_u, q_v, k, v, p, mask, lse, out, g, terms, key_blocks=True):
    """The backward kernel's arithmetic (rel_attention_bwd_plain's formulas),
    each product at its rounding: the recomputed unscaled S, P = exp2(S *
    scale log2(e) - lse log2(e)), dPr = dO V^T, dQ_u = dS K, dQ_v = dG p,
    dK = dS^T Q_u, dV = P^T dO, dP = dG^T Q_v; dq_u, dq_v and dp summed over
    the key blocks' partials (key_blocks=False: one product over all keys)."""
    valid = mask[:, None, None, :] & (lse > tra.NEG_INF / 2)[..., None]
    s_raw = _scores(q_u, q_v, k, p, terms) * math.sqrt(DK)
    prob = torch.where(valid, torch.exp2(s_raw * (LOG2E / math.sqrt(DK)) - lse[..., None] * LOG2E),
                       0.0)
    dpr = _mm("bhqd,bhkd->bhqk", g, v, terms["dpr"])
    ds = prob * (dpr - (g * out).sum(-1, keepdim=True)) / math.sqrt(DK)
    sums = _block_sums if key_blocks else (lambda d, fn: fn(d))
    return (sums(ds, lambda d: _mm("bhqk,bhkd->bhqd", d, k, terms["dqu"])),
            sums(ds, lambda d: _mm("bhqp,hpd->bhqd", tra.rel_unshift(d), p, terms["dqv"])),
            _mm("bhqk,bhqd->bhkd", ds, q_u, terms["dk"]), _mm("bhqk,bhqd->bhkd", prob, g, terms["dv"]),
            sums(ds, lambda d: _mm("bhqp,bhqd->hpd", tra.rel_unshift(d), q_v, terms["dp"])))


@pytest.fixture(scope="module")
def case():
    """Inputs as chip_smoke.py makes them (randn, the position table too),
    the JAX f32 forward, and the JAX backward kernel in interpret mode from
    its own forward's residuals."""
    rng = np.random.default_rng(7)
    b = len(LENS)
    q_u, q_v, k, v = (rng.standard_normal((b, H, T, DK)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((H, 2 * T - 1, DK)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(LENS)[:, None]
    g = rng.standard_normal((b, H, T, DK)).astype(np.float32) * mask[:, None, :, None]
    j = [jnp.asarray(x) for x in (q_u, q_v, k, v, p)]
    jmask = jnp.asarray(mask)
    out_j, lse_j = jra._rel_flash_impl(*j, jmask, block=64, interpret=True, return_lse=True)
    grads_j = jra._rel_flash_bwd_impl(*j, jmask, lse_j, out_j, jnp.asarray(g), block=64,
                                      interpret=True)
    to_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return {"args": [to_t(x) for x in (q_u, q_v, k, v, p)], "mask": torch.from_numpy(mask),
            "g": to_t(g), "lse": to_t(lse_j), "out": to_t(out_j),
            "fwd_ref": to_t(jra.dense_rel_attention(*j, jmask)),
            "bwd_ref": [to_t(x) for x in grads_j]}


def _fwd_err(case, terms):
    """Max abs error over the valid rows (a fully masked row is a uniform
    average in the kernel and 0 in the dense reference)."""
    got = _forward(*case["args"], case["mask"], terms)
    rows = case["mask"][:, None, :, None]
    return float(((got - case["fwd_ref"]) * rows).abs().max())


def _bwd_err(case, terms):
    got = _backward(*case["args"], case["mask"], case["lse"], case["out"], case["g"], terms)
    return max(float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
               for a, r in zip(got, case["bwd_ref"]))


def test_3xtf32_forward_is_within_the_f32_limit(case):
    assert _fwd_err(case, _terms(FWD_PRODUCTS)) <= FWD_TOL / 10


def test_3xtf32_backward_is_within_the_f32_limit(case):
    assert _bwd_err(case, _terms(BWD_PRODUCTS)) <= BWD_TOL / 10


@pytest.mark.parametrize("one", ("all",) + FWD_PRODUCTS)
def test_one_tf32_product_fails_the_forward_limit(case, one):
    assert _fwd_err(case, _terms(FWD_PRODUCTS, one)) > FWD_TOL


@pytest.mark.parametrize("one", ("all",) + BWD_PRODUCTS)
def test_one_tf32_product_fails_the_backward_limit(case, one):
    assert _bwd_err(case, _terms(BWD_PRODUCTS, one)) > BWD_TOL


def test_warpgroup_combine_is_within_the_forward_limit(case):
    """The forward's two warpgroups over interleaved 32-key halves, combined
    at the end, against one online softmax over whole 64-key tiles: the
    order of the sums only, far inside the limit."""
    args = (*case["args"], case["mask"], _terms(FWD_PRODUCTS))
    rows = case["mask"][:, None, :, None]
    diff = (_forward(*args) - _forward(*args, halves=1)) * rows
    assert float(diff.abs().max()) <= FWD_TOL / 100


def test_key_block_partials_sum_like_one_product(case):
    """The key-major kernel's f32 sums of 64-key partials (dq_u, dq_v, dp)
    against one 3xTF32 product over all keys: order only, far inside the
    limit."""
    args = (*case["args"], case["mask"], case["lse"], case["out"], case["g"],
            _terms(BWD_PRODUCTS))
    blocks, whole = _backward(*args), _backward(*args, key_blocks=False)
    for a, r in zip(blocks, whole):
        assert float((a - r).abs().max()) / max(1.0, float(r.abs().max())) <= BWD_TOL / 100


def test_exp2_of_the_folded_scale_is_within_the_f32_limit(case):
    """P as the kernel takes it, exp2(S * scale log2(e) - lse log2(e)) from
    the unscaled S, against exp(S * scale - lse) of the plain version."""
    valid = case["mask"][:, None, None, :] & (case["lse"] > tra.NEG_INF / 2)[..., None]
    q_u, q_v, k, _, p = case["args"]
    s = _scores(q_u, q_v, k, p, _terms(BWD_PRODUCTS))
    lse = case["lse"][..., None]
    got = torch.where(valid, torch.exp2(s * math.sqrt(DK) * (LOG2E / math.sqrt(DK)) - lse * LOG2E),
                      0.0)
    ref = torch.where(valid, torch.exp(s - lse), 0.0)
    assert float((got - ref).abs().max()) <= BWD_TOL / 100
