"""The method of the f32 path of csrc/attention.cu, checked on the CPU: both
products (S = Q K^T and O = P V) in 3xTF32 (each operand split into hi,
rounded to TF32 as cvt.rna rounds, and lo = v - hi, which the tensor core
reads truncated to TF32; lo_a hi_b + hi_a lo_b + hi_a hi_b in f32), with the
kernel's online softmax over key tiles of 64 (as its blocks of 64 query
rows run it), emulated in plain PyTorch at the kernel's rounding points,
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
TILE = 64                   # keys per step of the kernel's online softmax
MASKED = -1e30              # the kernel's score of a masked key


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


def _forward(q, k, v, mask, terms):
    """The kernel's arithmetic: S from the split product, masked keys at
    -1e30, then per key tile the running maximum m, P = exp(S - m) split as
    the A of P V, the running sum from the unsplit P."""
    s = _mm("bhqd,bhkd->bhqk", q, k, terms["qk"]) / math.sqrt(DK)
    s = s.masked_fill(~mask[:, None, None, :], MASKED)
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for j0 in range(0, T, TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm("bhqk,bhkd->bhqd", p, v[..., j0:j0 + TILE, :], terms["pv"])
        m = m_new
    return acc / l.clamp_min(1e-20)


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
