"""Port's plain masked attention (lip2speech_tpu_torch/ops/attention.py) and
its bias implementation of relative-position attention (ops/rel_attention.py,
impl="bias") against the JAX package: the dense math and the Pallas flash
kernels run in interpret mode. Valid query rows are compared; rows whose keys
are all masked are cut off by every caller. Tolerance 2e-5: float32 on both
sides, only the summation order differs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.ops import pallas_attention as jatt
from lip2speech_tpu.ops import pallas_rel_attention as jra
from lip2speech_tpu_torch.ops import attention as tatt
from lip2speech_tpu_torch.ops import rel_attention as tra

from test_torch_rel_attention import _inputs, _valid_rows_close

ATOL = 2e-5
# T below, at and above the interpret-mode block (32), and not a multiple of it
SHAPES = [(12, [12, 7]), (32, [32, 20]), (45, [45, 33])]


def _qkv(t, lens, seed=3, b=2, h=2, dk=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, dk)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    return q, k, v, mask


@pytest.mark.parametrize("t,lens", SHAPES)
def test_reference_matches_jax_reference(t, lens):
    q, k, v, mask = _qkv(t, lens)
    ref = np.asarray(jatt.reference_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = tatt.reference_attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    _valid_rows_close(got, ref, mask, atol=ATOL)


@pytest.mark.parametrize("t,lens", SHAPES)
def test_attention_matches_jax_flash_interpret(t, lens):
    q, k, v, mask = _qkv(t, lens, seed=4)
    ref = np.asarray(jatt.flash_attention(*map(jnp.asarray, (q, k, v, mask)),
                                          block_q=32, block_k=32, interpret=True))
    got = tatt.attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    _valid_rows_close(got, ref, mask, atol=ATOL)


def test_attention_without_mask():
    q, k, v, _ = _qkv(45, [45, 45], seed=5)
    ones = np.ones((2, 45), bool)
    flash = np.asarray(jatt.flash_attention(*map(jnp.asarray, (q, k, v, ones)),
                                            block_q=32, block_k=32, interpret=True))
    dense = np.asarray(jatt.reference_attention(*map(jnp.asarray, (q, k, v)), None))
    got = tatt.attention(*map(torch.from_numpy, (q, k, v)), None).numpy()
    np.testing.assert_allclose(got, flash, atol=ATOL)
    np.testing.assert_allclose(got, dense, atol=ATOL)


def test_fully_masked_row_is_a_finite_average():
    q, k, v, mask = _qkv(12, [12, 0])
    got = tatt.attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(1, keepdims=True), v[1].shape),
                               atol=ATOL)


@pytest.mark.parametrize("t,lens", [(12, [12, 7]), (40, [40, 33])])
def test_dense_bias_matches_jax_dense_bias(t, lens):
    q_u, q_v, k, v, p, mask = _inputs(t, lens, seed=6)
    b, h, _, dk = q_u.shape
    bias = tra.rel_position_bias(torch.from_numpy(q_v), torch.from_numpy(p))
    assert bias.shape == (b, h, t, t) and bias.dtype == torch.float32
    flat = lambda x: jnp.asarray(x).reshape(b * h, t, -1)  # noqa: E731
    maskf = jnp.repeat(jnp.asarray(mask, jnp.int32), h, axis=0).reshape(b * h, 1, t)
    ref = np.asarray(jra._dense_bias_attention_flat(flat(q_u), flat(k), flat(v),
                                                    flat(bias.numpy()), maskf))
    got = tra.dense_bias_attention(*map(torch.from_numpy, (q_u, k, v)), bias,
                                   torch.from_numpy(mask)).numpy()
    _valid_rows_close(got, ref.reshape(b, h, t, dk), mask, atol=ATOL)


@pytest.mark.parametrize("jax_impl", ["bias", "shear"])
@pytest.mark.parametrize("t,lens", [(12, [12, 7]), (40, [40, 33])])
def test_rel_attention_bias_matches_jax_flash_interpret(t, lens, jax_impl):
    args = _inputs(t, lens, seed=7)
    ref = np.asarray(jra.rel_flash_attention(*map(jnp.asarray, args), block=16,
                                             interpret=True, impl=jax_impl))
    got = tra.rel_attention(*map(torch.from_numpy, args), impl="bias").numpy()
    _valid_rows_close(got, ref, args[-1], atol=ATOL)


def test_impl_default_comes_from_the_environment(monkeypatch):
    args = [torch.from_numpy(a) for a in _inputs(12, [12, 7], seed=8)]
    calls = []
    monkeypatch.setattr(tra, "dense_bias_attention",
                        lambda *a: calls.append("bias") or args[0])
    monkeypatch.setattr(tra, "dense_rel_attention",
                        lambda *a: calls.append("shear") or args[0])
    monkeypatch.delenv("LIP2SPEECH_FLASH_IMPL", raising=False)
    tra.rel_attention(*args)
    monkeypatch.setenv("LIP2SPEECH_FLASH_IMPL", "bias")
    tra.rel_attention(*args)
    tra.rel_attention(*args, impl="shear")
    assert calls == ["shear", "bias", "shear"]
    monkeypatch.setenv("LIP2SPEECH_FLASH_IMPL", "dense")
    with pytest.raises(ValueError, match="unknown flash impl"):
        tra.rel_attention(*args)


def test_unknown_impl_and_dropout_raise():
    args = [torch.from_numpy(a) for a in _inputs(12, [12, 7])]
    with pytest.raises(ValueError, match="unknown flash impl"):
        tra.rel_attention(*args, impl="roll")
    plain = tra.rel_attention(*args)
    for impl in ("shear", "bias"):
        with pytest.raises(ValueError, match="dropout rate"):
            tra.rel_attention(*args, impl=impl, dropout_rate=1.5)
        dropped = tra.rel_attention(*args, impl=impl, dropout_rate=0.1, seed=3)
        assert dropped.shape == plain.shape and not torch.allclose(dropped, plain)


def test_kernel_launchers_reject_cpu_tensors():
    q_u, q_v, k, v, p, mask = (torch.from_numpy(a) for a in _inputs(12, [12, 7], dk=64))
    bias = tra.rel_position_bias(q_v, p)
    for kernel, args in ((tatt.attention_kernel, (q_u, k, v, mask)),
                         (tra.rel_attention_bias_kernel, (q_u, k, v, bias, mask))):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(*args)
        assert kernel.launches == 0


@pytest.mark.parametrize("t,lens", [(12, [12, 7]), (45, [45, 33])])
def test_attention_fn_gradient_matches_jax_custom_vjp(monkeypatch, t, lens):
    """AttentionFn's backward (dense recompute through reference_attention)
    against the JAX entry's custom VJP around its interpret-mode kernel. The
    CUDA kernel cannot run here, so its plain version stands in for the
    forward launch; the backward under test is the real one."""
    q, k, v, mask = _qkv(t, lens, seed=6)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    g = g * mask[:, None, :, None]
    jmask = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jatt._flash_diff(True, a, b, c, jmask),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    calls = []

    def fake_kernel(q_, k_, v_, mask_):
        calls.append(torch.is_grad_enabled())
        return tatt.reference_attention(q_, k_, v_, mask_)

    monkeypatch.setattr(tatt, "attention_kernel", fake_kernel)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.AttentionFn.apply(tq, tk, tv, torch.from_numpy(mask))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert calls == [False]                  # the forward ran outside autograd's graph
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL)
    # without a mask, and through the public entry on the CPU
    out = tatt.AttentionFn.apply(tq, tk, tv, None)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    ref = torch.autograd.grad(tatt.attention(tq, tk, tv, None), (tq, tk, tv), torch.from_numpy(g))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-6)
