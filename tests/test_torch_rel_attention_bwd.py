"""The plain backward versions of the port's rel-position attention
(lip2speech_tpu_torch/ops/rel_attention.py: `rel_attention_bwd_plain`,
`bias_attention_bwd_plain`) against the JAX package: its Pallas backward
kernels run in interpret mode and jax.vjp of its dense math; the `keep=`
dropout formulas against PyTorch's autograd through the dense forward under
the same mask; and the dropout mask generator itself. Tolerance 3e-5 as the
JAX package's own backward tests (f32, sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.ops import nn as jops
from lip2speech_tpu.ops import pallas_rel_attention as jra
from lip2speech_tpu_torch.ops import dropout_mask as dm
from lip2speech_tpu_torch.ops import rel_attention as tra

ATOL = 3e-5
NAMES = ("dq_u", "dq_v", "dk", "dv", "dp")


def _inputs(t, lens, seed=11, b=2, h=2, dk=16):
    """q_u, q_v, k, v, p, mask, g; g is zero on padded query rows."""
    rng = np.random.default_rng(seed)
    q_u, q_v, k, v = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(4))
    pe = jops.sinusoidal_rel_pos_encoding(t, h * dk)
    p = np.ascontiguousarray(pe.reshape(2 * t - 1, h, dk).transpose(1, 0, 2))
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    g = rng.standard_normal((b, h, t, dk)).astype(np.float32) * mask[:, None, :, None]
    return q_u, q_v, k, v, p, mask, g


def _torch(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _forward_stats(q_u, q_v, k, v, p, mask):
    """The port's plain forward and its row log-sum-exp, as the kernel saves them."""
    out = tra.dense_rel_attention(q_u, q_v, k, v, p, mask)
    return out, tra.masked_lse(tra.rel_scores(q_u, q_v, k, p), mask)


# 40 and 33 are not multiples of the block (16): the JAX wrapper pads, the
# port indexes with bounds checks; (24, [24, 0]) has a fully masked batch row
@pytest.mark.parametrize("t,lens", [(40, [40, 33]), (33, [33, 26]), (24, [24, 0])])
def test_shear_backward_matches_jax_kernel_interpret(t, lens):
    *args, mask, g = _inputs(t, lens)
    j = [jnp.asarray(a) for a in args]
    out_j, lse_j = jra._rel_flash_impl(*j, jnp.asarray(mask), block=16, interpret=True,
                                       return_lse=True)
    ref = jra._rel_flash_bwd_impl(*j, jnp.asarray(mask), lse_j, out_j, jnp.asarray(g),
                                  block=16, interpret=True)
    ta = _torch(args)
    tmask = torch.from_numpy(mask)
    # from the JAX kernel's own residuals (its rows with no key carry the
    # flash kernel's output, not 0: their gradient must be 0 all the same)
    got = tra.rel_attention_bwd_plain(*ta, tmask, torch.from_numpy(np.asarray(lse_j)),
                                      torch.from_numpy(np.asarray(out_j)), torch.from_numpy(g))
    for name, a, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, err_msg=name)
    # and from the port's own forward
    out, lse = _forward_stats(*ta, tmask)
    got = tra.rel_attention_bwd_plain(*ta, tmask, lse, out, torch.from_numpy(g))
    for name, a, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("t,lens", [(40, [40, 33]), (33, [33, 26]), (24, [24, 0])])
def test_shear_backward_matches_jax_vjp_of_dense(t, lens):
    *args, mask, g = _inputs(t, lens, seed=12)
    jmask = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: jra.dense_rel_attention(*a, jmask), *map(jnp.asarray, args))
    ref = vjp(jnp.asarray(g))
    ta, tmask = _torch(args), torch.from_numpy(mask)
    out, lse = _forward_stats(*ta, tmask)
    got = tra.rel_attention_bwd_plain(*ta, tmask, lse, out, torch.from_numpy(g))
    for name, a, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, err_msg=name)
    if 0 in lens:                                   # the fully masked batch row
        row = lens.index(0)
        for a in got[:4]:
            assert float(a[row].abs().max()) == 0.0


@pytest.mark.parametrize("t,lens", [(32, [32, 25]), (48, [48, 0])])
def test_bias_backward_matches_jax_kernel_interpret(t, lens):
    """T is a block multiple here: `_flash_bias_bwd_impl` takes the flat,
    already padded layout."""
    q_u, q_v, k, v, p, mask, g = _inputs(t, lens, seed=13)
    b, h, _, dk = q_u.shape
    tq_v, tp = torch.from_numpy(q_v), torch.from_numpy(p)
    bias = tra.rel_position_bias(tq_v, tp)
    flat = lambda x: jnp.asarray(x).reshape(b * h, t, -1)  # noqa: E731
    maskf = jnp.repeat(jnp.asarray(mask).astype(jnp.int32), h, axis=0).reshape(b * h, 1, t)
    seed = jnp.zeros((1,), jnp.int32)
    jbias = flat(bias.numpy())
    out_j, lse_j = jra._flash_bias_impl(flat(q_u), flat(k), flat(v), jbias, maskf, seed, blk=16,
                                        interpret=True, return_lse=True)
    ref = jra._flash_bias_bwd_impl(flat(q_u), flat(k), flat(v), jbias, maskf, lse_j, out_j,
                                   flat(g), blk=16, interpret=True)
    tq_u, tk, tv = _torch((q_u, k, v))
    got = tra.bias_attention_bwd_plain(
        tq_u, tk, tv, bias, torch.from_numpy(mask),
        torch.from_numpy(np.asarray(lse_j)).reshape(b, h, t),
        torch.from_numpy(np.asarray(out_j)).reshape(b, h, t, dk), torch.from_numpy(g))
    for name, a, r in zip(("dq_u", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy().reshape(np.asarray(r).shape), np.asarray(r),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("t,lens", [(33, [33, 26]), (24, [24, 0])])
def test_bias_route_gradients_match_jax_vjp_of_dense(t, lens):
    """The whole bias route (bias built outside, its gradient carried back
    to q_v and p by autograd through rel_position_bias) against jax.vjp of
    the dense math, at a T that is not a block multiple."""
    *args, mask, g = _inputs(t, lens, seed=14)
    jmask = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: jra.dense_rel_attention(*a, jmask), *map(jnp.asarray, args))
    ref = vjp(jnp.asarray(g))
    q_u, q_v, k, v, p = (x.requires_grad_() for x in _torch(args))
    tmask = torch.from_numpy(mask)
    bias = tra.rel_position_bias(q_v, p)
    with torch.no_grad():
        out = tra.dense_bias_attention(q_u, k, v, bias, tmask)
        lse = tra.masked_lse(tra.bias_scores(q_u, k, bias), tmask)
        dq_u, dk, dv, dbias = tra.bias_attention_bwd_plain(q_u, k, v, bias, tmask, lse, out,
                                                           torch.from_numpy(g))
    dq_v, dp = torch.autograd.grad(bias, (q_v, p), dbias)
    for name, a, r in zip(NAMES, (dq_u, dq_v, dk, dv, dp), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("impl", ["shear", "bias"])
def test_keep_formulas_match_autograd_under_the_same_mask(impl, rate):
    """Backward with dropout, written from the formulas, against PyTorch's
    autograd through the dense forward with the identical keep mask."""
    *args, mask, g = _inputs(37, [37, 20], seed=15)
    b, h, t, _ = args[0].shape
    keep = dm.attention_keep_mask(77, rate, b, h, t)
    tmask, tg = torch.from_numpy(mask), torch.from_numpy(g)
    q_u, q_v, k, v, p = (x.requires_grad_() for x in _torch(args))
    if impl == "shear":
        out = tra.dense_rel_attention(q_u, q_v, k, v, p, tmask, keep, rate)
        ref = torch.autograd.grad(out, (q_u, q_v, k, v, p), tg)
        with torch.no_grad():
            lse = tra.masked_lse(tra.rel_scores(q_u, q_v, k, p), tmask)
            got = tra.rel_attention_bwd_plain(q_u, q_v, k, v, p, tmask, lse, out, tg, keep, rate)
    else:
        bias = tra.rel_position_bias(q_v, p).detach().requires_grad_()
        out = tra.dense_bias_attention(q_u, k, v, bias, tmask, keep, rate)
        ref = torch.autograd.grad(out, (q_u, k, v, bias), tg)
        with torch.no_grad():
            lse = tra.masked_lse(tra.bias_scores(q_u, k, bias), tmask)
            got = tra.bias_attention_bwd_plain(q_u, k, v, bias, tmask, lse, out, tg, keep, rate)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=ATOL)
    # the public entry drops under the same mask on the CPU, for both routes
    with torch.no_grad():
        same = tra.rel_attention(q_u, q_v, k, v, p, tmask, impl=impl, dropout_rate=rate, seed=77)
        expect = tra.dense_rel_attention(q_u, q_v, k, v, p, tmask, keep, rate)
    np.testing.assert_allclose(same.numpy(), expect.numpy(), atol=1e-5)


def test_rel_unshift_is_the_transpose_of_rel_shift():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 7, 13)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 3, 7, 7)).astype(np.float32))
    lhs = float((tra.rel_shift(x) * y).sum())
    rhs = float((x * tra.rel_unshift(y)).sum())
    assert abs(lhs - rhs) < 1e-4


# Random123's known-answer vectors for Philox4x32-10: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,expect", PHILOX_KAT)
def test_philox_known_answers(ctr, key, expect):
    words = dm.philox4x32_10(*(torch.tensor(c, dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == expect


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_mask_rate_and_determinism(rate):
    b, h, t = 2, 4, 45                                  # T not a multiple of 4
    m1 = dm.attention_keep_mask(5, rate, b, h, t)
    assert m1.shape == (b, h, t, t) and m1.dtype == torch.bool
    assert torch.equal(m1, dm.attention_keep_mask(5, rate, b, h, t))
    assert not torch.equal(m1, dm.attention_keep_mask(6, rate, b, h, t))
    assert not torch.equal(m1, dm.attention_keep_mask(5 + 2 ** 32, rate, b, h, t))  # high word
    n = m1.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(m1.float().mean()) - (1 - rate)) < 3 * sigma
    # a slice (b*h) does not repeat its neighbour, and the mask of a shorter
    # sequence is the corner of the longer one's: bits depend on (i, j) only
    assert not torch.equal(m1[0, 0], m1[0, 1])
    assert torch.equal(dm.attention_keep_mask(5, rate, b, h, 20), m1[..., :20, :20])
    assert dm.attention_keep_mask(5, 0.0, b, h, t).all()


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5, 1.0 - 2.0 ** -24])
def test_dropout_threshold_is_taken_from_the_float32_rate(rate):
    """csrc/philox.cuh computes uint32(double(float32 rate) * 2**32), clamped."""
    want = min(int(float(np.float32(rate)) * 2 ** 32), 2 ** 32 - 1)
    assert dm.dropout_threshold(rate) == want
    assert 0 < want < 2 ** 32


def test_dropout_arguments_are_checked():
    args = _torch(_inputs(8, [8, 8])[:5])
    mask = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="rate"):
        tra.rel_attention(*args, mask, dropout_rate=1.0)
    with pytest.raises(ValueError, match="seed"):
        tra.rel_attention(*args, mask, dropout_rate=0.1, seed=-1)


def test_backward_kernel_launchers_reject_cpu_tensors():
    q_u, q_v, k, v, p, mask, g = _inputs(12, [12, 7], dk=64)
    ta, tmask, tg = _torch((q_u, q_v, k, v, p)), torch.from_numpy(mask), torch.from_numpy(g)
    out, lse = _forward_stats(*ta, tmask)
    bias = tra.rel_position_bias(ta[1], ta[4])
    for kernel, call in (
            (tra.rel_attention_bwd_kernel, lambda: tra.rel_attention_bwd_kernel(
                *ta, tmask, lse, out, tg)),
            (tra.rel_attention_bias_bwd_kernel, lambda: tra.rel_attention_bias_bwd_kernel(
                ta[0], ta[2], ta[3], bias, tmask, lse, out, tg))):
        before = kernel.launches
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert kernel.launches == before
