"""The method of the f32 path of csrc/attention.cu, checked on the CPU: both
products (S = Q K^T and O = P V) in 3xTF32 (each operand split into hi,
rounded to TF32 as cvt.rna rounds, and lo = v - hi, which the tensor core
reads truncated to TF32; lo_a hi_b + hi_a lo_b + hi_a hi_b in f32; the
split once a tile for an operand in shared memory, K and V, and at the
fragment for one in registers, Q and P, the same values either way),
with the kernel's online softmax (flash_fwd_hopper.cuh: a block's two
consumer warpgroups take alternate whole 64-key tiles, 0, 2, 4, .. and 1,
3, 5, .., each with its own running maximum and sum in log2 units, exp2 of
the scores times scale * log2(e), combined at the end), emulated in plain
PyTorch at the kernel's rounding points,
against the JAX package's Pallas kernel (`flash_attention` in interpret
mode) and its `reference_attention`, in f32, within the limit that
chip_smoke.py holds the kernel to on the card: 3e-5 absolute on valid rows
(phase 6). One TF32 product (1xTF32: hi_a hi_b), in both products or in
either one, must fall outside that limit, so that it tells the method from
the cheaper one. This checks the method, not the kernel, which runs only on
the card. T = 130 (three key tiles, the last one ragged) with a fully
masked batch row; head dim 64, the kernel's only one."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import pallas_attention as jatt

TOL = 3e-5                  # chip_smoke.py phase 6, absolute, f32
PRODUCTS = ("qk", "pv")
LENS = (130, 97, 0)
H, T, DK = 2, 130, 64
TILE = 64                   # keys per step of the kernel's loop
MASKED = -1e30              # the kernel's score of a masked key
LOG2E = 1.4426950408889634


def _tf32(t):
    """cvt.rna.tf32.f32 on the f32 bits, as the kernel's split computes it."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tc(t):
    """An f32 register as the tensor core reads it for a TF32 product."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(eq, a, b, terms):
    """einsum of f32 operands at the kernel's rounding: terms 3 = lo_a hi_b +
    hi_a lo_b + hi_a hi_b (3xTF32), 1 = hi_a hi_b (1xTF32). Products of two
    TF32 values are exact in f32."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = torch.einsum(eq, _tc(a - ah), bh) + torch.einsum(eq, ah, _tc(b - bh)) + out
    return out


def _terms(one=None):
    """Both products in 3xTF32; `one` ("all" or a product's name) in 1xTF32."""
    return {name: 1 if one in ("all", name) else 3 for name in PRODUCTS}


def _forward(q, k, v, mask, terms, streams=2):
    """The kernel's arithmetic: S from the split product, times scale *
    log2(e), masked keys at -1e30 log2(e); warpgroup c takes tiles c, c +
    streams, .. with its own running maximum m, P = exp2(S - m) split as the
    A of P V, the running sum from the unsplit P; then the warpgroups' parts
    merged in order as the kernel merges them (streams=1: one online softmax
    over every tile in order)."""
    s = _mm("bhqd,bhkd->bhqk", q, k, terms["qk"]) * (LOG2E / math.sqrt(DK))
    s = s.masked_fill(~mask[:, None, None, :], MASKED * LOG2E)
    merged = None
    for c in range(streams):
        m = torch.full(s.shape[:-1] + (1,), MASKED * LOG2E)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q)
        for j0 in range(TILE * c, T, TILE * streams):
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


def _merge(x, y):
    """The kernel's merge of two parts (max, sum, output) of the same rows."""
    (m0, l0, acc0), (m1, l1, acc1) = x, y
    m = torch.maximum(m0, m1)
    a, b = torch.exp2(m0 - m), torch.exp2(m1 - m)
    return m, l0 * a + l1 * b, acc0 * a + acc1 * b


@pytest.fixture(scope="module")
def case():
    """Inputs as chip_smoke.py makes them (randn), the JAX Pallas kernel in
    interpret mode and the JAX dense reference, both f32."""
    rng = np.random.default_rng(7)
    b = len(LENS)
    q, k, v = (rng.standard_normal((b, H, T, DK)).astype(np.float32) for _ in range(3))
    mask = np.arange(T)[None, :] < np.asarray(LENS)[:, None]
    j = [jnp.asarray(x) for x in (q, k, v, mask)]
    to_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return {"args": [to_t(x) for x in (q, k, v)], "mask": torch.from_numpy(mask),
            "refs": {"flash_interpret": to_t(jatt.flash_attention(*j, interpret=True)),
                     "reference": to_t(jatt.reference_attention(*j))}}


def _err(case, terms, ref):
    """Max abs error over the valid rows (a fully masked row is a uniform
    average in the kernel, over the padded keys too in the JAX kernel)."""
    got = _forward(*case["args"], case["mask"], terms)
    rows = case["mask"][:, None, :, None]
    return float(((got - case["refs"][ref]) * rows).abs().max())


@pytest.mark.parametrize("ref", ("flash_interpret", "reference"))
def test_3xtf32_is_within_the_f32_limit(case, ref):
    assert _err(case, _terms(), ref) <= TOL / 10


@pytest.mark.parametrize("one", ("all",) + PRODUCTS)
def test_one_tf32_product_fails_the_f32_limit(case, one):
    assert _err(case, _terms(one), "reference") > TOL


def test_warpgroup_combine_is_within_the_f32_limit(case):
    """The two warpgroups' online softmaxes over alternate whole 64-key
    tiles, combined at the end, against one online softmax over every tile
    in order: the order of the sums only, far inside the limit."""
    args = (*case["args"], case["mask"], _terms())
    rows = case["mask"][:, None, :, None]
    diff = (_forward(*args) - _forward(*args, streams=1)) * rows
    assert float(diff.abs().max()) <= TOL / 100

