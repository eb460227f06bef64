"""The rounding points of the bf16 tensor-core rel-position attention
kernels (lip2speech_tpu_torch/csrc/rel_attention.cu and
rel_attention_bwd.cu, the shear route, and rel_attention_bias.cu and
rel_attention_bias_bwd.cu, the bias route; dtype 1), emulated in plain
PyTorch on the CPU, against the f32 plain versions of
lip2speech_tpu_torch/ops/rel_attention.py (and, for the bias route, the JAX
package's bias kernels in interpret mode).

The kernels take bf16 inputs and accumulate every product in f32. Where
they round:
  forward   the probabilities exp(S - m) of each 64-key tile, at the running
            maximum m and after the dropout scale, to bf16 before P V; the
            row sum and the log-sum-exp stay f32; the output to bf16. The
            bias route's S is q_u.k * scale + bias with the f32 bias added
            after the scale, never rounded;
  backward  dS = P o (dPr o keep - D) / 8 and P~ = P o keep to bf16 before
            the gradient products, and with them (shear) the un-sheared band
            tile dG[i, T-1-i+j] = dS[i, j] that gives dq_v and dp; (bias)
            dbias is the f32 dS before the scale and the rounding; D comes
            from the bf16 forward output; the gradients to bf16.
The emulation repeats exactly that (test-local: the package gains no code
path). The assertions use the tolerances the kernels are held to on the
card: 2e-2 forward, 1e-2 of max(1, |ref|) backward.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import pallas_rel_attention as jra
from lip2speech_tpu_torch.ops import dropout_mask as dm
from lip2speech_tpu_torch.ops import rel_attention as tra

FWD_TOL = 2e-2
BWD_TOL = 1e-2
TILE = 64                    # keys per tile of the kernels' online softmax


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _inputs(t, seed, b=2, h=8, dk=64):
    """bf16-valued q_u, q_v, k, v, p (as the kernel reads them), the key
    mask (batch row 0 ragged, row 1 fully masked) and dO (bf16, zero on
    padded rows), all f32 tensors."""
    rng = np.random.default_rng(seed)
    q_u, q_v, k, v, g = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(5))
    p = rng.standard_normal((h, 2 * t - 1, dk)).astype(np.float32)
    lens = [round(0.83 * t), 0]
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    xs = [_bf16(torch.from_numpy(x)) for x in (q_u, q_v, k, v, p)]
    g = _bf16(torch.from_numpy(g)) * torch.from_numpy(mask)[:, None, :, None]
    return xs, torch.from_numpy(mask), g, lens


def _emulate_forward(q_u, q_v, k, v, p, mask, keep, rate):
    """rel_attention.cu's bf16 kernel: online softmax over 64-key tiles."""
    s = tra.rel_scores(q_u, q_v, k, p).masked_fill(~mask[:, None, None, :], tra.NEG_INF)
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q_u)
    for j0 in range(0, s.shape[-1], TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pt = torch.exp(st - m_new)
        l = l * alpha + pt.sum(-1, keepdim=True)
        if keep is not None:
            pt = pt * keep[..., j0:j0 + TILE] * (1.0 / (1.0 - rate))
        acc = acc * alpha + _bf16(pt) @ v[..., j0:j0 + TILE, :]
        m = m_new
    l = l.clamp_min(1e-20)
    return _bf16(acc / l), (m + torch.log(l))[..., 0]


def _emulate_backward(q_u, q_v, k, v, p, mask, lse, out, g, keep, rate):
    """rel_attention_bwd.cu's bf16 kernels: (dq_u, dq_v, dk, dv, dp)."""
    s = tra.rel_scores(q_u, q_v, k, p)
    valid = mask[:, None, None, :] & (lse > tra.NEG_INF / 2)[..., None]
    prob = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    kf = 1.0 if keep is None else keep * (1.0 / (1.0 - rate))
    delta = (g * out).sum(-1, keepdim=True)
    dpr = g @ v.transpose(-1, -2)
    ds = _bf16(prob * (dpr * kf - delta) * (1.0 / math.sqrt(q_u.shape[-1])))
    pd = _bf16(prob * kf)
    dg = tra.rel_unshift(ds)
    grads = (ds @ k, torch.einsum("bhqp,hpd->bhqd", dg, p), ds.transpose(-1, -2) @ q_u,
             pd.transpose(-1, -2) @ g, torch.einsum("bhqp,bhqd->hpd", dg, q_v))
    return tuple(_bf16(x) for x in grads)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [192, 235, 470])   # 192: a batch-1 request's 96 frames
def test_bf16_rounding_points_fit_the_kernel_tolerances(t, rate):
    xs, mask, g, lens = _inputs(t, seed=t + int(rate * 10))
    b, h = xs[0].shape[:2]
    keep = dm.attention_keep_mask(97, rate, b, h, t, torch.device("cpu")) if rate else None
    # the f32 references: the port's plain versions (the JAX dense function
    # agrees with them without dropout)
    ref = tra.dense_rel_attention(*xs, mask, keep, rate)
    lse_ref = tra.masked_lse(tra.rel_scores(*[xs[i] for i in (0, 1, 2, 4)]), mask)
    if keep is None:
        ref_j = jra.dense_rel_attention(*[jnp.asarray(x.numpy()) for x in xs],
                                        jnp.asarray(mask.numpy()))
        np.testing.assert_allclose(np.asarray(ref_j)[0, :, :lens[0]], ref[0, :, :lens[0]].numpy(),
                                   atol=1e-5)
    grads_ref = tra.rel_attention_bwd_plain(*xs, mask, lse_ref, ref, g, keep, rate)

    out, lse = _emulate_forward(*xs, mask, keep, rate)
    n = lens[0]
    fwd_err = float((out - ref)[0, :, :n].abs().max())
    assert fwd_err <= FWD_TOL, fwd_err
    assert float((lse - lse_ref)[0, :, :n].abs().max()) <= 1e-4       # f32 sums only

    grads = _emulate_backward(*xs, mask, lse, out, g, keep, rate)
    for name, a, r in zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads, grads_ref):
        err = float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
        assert err <= BWD_TOL, (name, err)
    # the fully masked batch row gets exactly zero gradient
    for a in grads[:4]:
        assert float(a[1].abs().max()) == 0.0



def _emulate_bias_forward(q_u, k, v, bias, mask, keep, rate):
    """rel_attention_bias.cu's bf16 kernel: the f32 bias added after the
    scale, then rel_attention.cu's online softmax over 64-key tiles."""
    s = tra.bias_scores(q_u, k, bias).masked_fill(~mask[:, None, None, :], tra.NEG_INF)
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q_u)
    for j0 in range(0, s.shape[-1], TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pt = torch.exp(st - m_new)
        l = l * alpha + pt.sum(-1, keepdim=True)
        if keep is not None:
            pt = pt * keep[..., j0:j0 + TILE] * (1.0 / (1.0 - rate))
        acc = acc * alpha + _bf16(pt) @ v[..., j0:j0 + TILE, :]
        m = m_new
    l = l.clamp_min(1e-20)
    return _bf16(acc / l), (m + torch.log(l))[..., 0]


def _emulate_bias_backward(q_u, k, v, bias, mask, lse, out, g, keep, rate):
    """rel_attention_bias_bwd.cu's bf16 kernel: (dq_u, dk, dv, dbias)."""
    s = tra.bias_scores(q_u, k, bias)
    valid = mask[:, None, None, :] & (lse > tra.NEG_INF / 2)[..., None]
    prob = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    kf = 1.0 if keep is None else keep * (1.0 / (1.0 - rate))
    delta = (g * out).sum(-1, keepdim=True)
    dbias = prob * (g @ v.transpose(-1, -2) * kf - delta)        # f32, unscaled
    ds = _bf16(dbias * (1.0 / math.sqrt(q_u.shape[-1])))
    pd = _bf16(prob * kf)
    grads = (ds @ k, ds.transpose(-1, -2) @ q_u, pd.transpose(-1, -2) @ g)
    return (*(_bf16(x) for x in grads), dbias)


def _jax_bias_route(q_u, k, v, bias, mask, g, blk=TILE):
    """The JAX package's `_flash_bias_impl` and `_flash_bias_bwd_impl` in
    interpret mode on the same inputs, padded to a block multiple as
    `_rel_flash_bias` pads them (padded keys masked): out and the gradients
    (dq_u, dk, dv, dbias), cut back to T."""
    b, h, t, dk = q_u.shape
    t_pad = -(-t // blk) * blk
    pad = t_pad - t

    def flat(x, cols=0):
        x = torch.nn.functional.pad(x, (0, cols, 0, pad))
        return jnp.asarray(x.reshape(b * h, t_pad, -1).numpy())

    maskf = np.zeros((b, t_pad), np.int32)
    maskf[:, :t] = mask.numpy()
    maskf = jnp.asarray(np.repeat(maskf, h, axis=0).reshape(b * h, 1, t_pad))
    qu_j, k_j, v_j, g_j = (flat(x) for x in (q_u, k, v, g))
    bias_j = flat(bias, pad)
    out_j, lse_j = jra._flash_bias_impl(qu_j, k_j, v_j, bias_j, maskf, jnp.zeros((1,), jnp.int32),
                                        blk=blk, interpret=True, return_lse=True)
    grads = jra._flash_bias_bwd_impl(qu_j, k_j, v_j, bias_j, maskf, lse_j, out_j, g_j, blk=blk,
                                     interpret=True)
    cut = lambda x, w: torch.from_numpy(np.array(x)).reshape(b, h, t_pad, w)[:, :, :t]  # noqa: E731
    return cut(out_j, dk), [cut(x, dk) for x in grads[:3]] + [cut(grads[3], t_pad)[..., :t]]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [127, 130])   # odd T: the kernels' single-float bias path
def test_bias_route_bf16_rounding_points_fit_the_kernel_tolerances(t, rate):
    """B2 H2, batch row 0 ragged, row 1 fully masked (zero gradient)."""
    xs, mask, g, lens = _inputs(t, seed=2 * t + int(rate * 10), h=2)
    q_u, q_v, k, v, p = xs
    bias = tra.rel_position_bias(q_v, p)           # f32, as the route builds it
    b, h = q_u.shape[:2]
    keep = dm.attention_keep_mask(98, rate, b, h, t, torch.device("cpu")) if rate else None
    ref = tra.dense_bias_attention(q_u, k, v, bias, mask, keep, rate)
    lse_ref = tra.masked_lse(tra.bias_scores(q_u, k, bias), mask)
    grads_ref = tra.bias_attention_bwd_plain(q_u, k, v, bias, mask, lse_ref, ref, g, keep, rate)

    out, lse = _emulate_bias_forward(q_u, k, v, bias, mask, keep, rate)
    n = lens[0]
    assert float((out - ref)[0, :, :n].abs().max()) <= FWD_TOL
    assert float((lse - lse_ref)[0, :, :n].abs().max()) <= 1e-4        # f32 sums only
    grads = _emulate_bias_backward(q_u, k, v, bias, mask, lse, out, g, keep, rate)
    refs = [grads_ref]
    if keep is None:         # the JAX kernels (no dropout off the TPU), on the same inputs
        out_j, grads_j = _jax_bias_route(q_u, k, v, bias, mask, g)
        assert float((out - out_j)[0, :, :n].abs().max()) <= FWD_TOL
        refs.append(grads_j)
    for r_set in refs:
        for name, a, r in zip(("dq_u", "dk", "dv", "dbias"), grads, r_set):
            err = float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
            assert err <= BWD_TOL, (name, err)
    for a in grads:          # the fully masked batch row: exactly zero gradient
        assert float(a[1].abs().max()) == 0.0
