"""Port's relative-position attention (lip2speech_tpu_torch/ops/rel_attention.py)
against the JAX package: its dense math and its Pallas flash kernel run in
interpret mode. Valid query rows are compared; fully masked rows differ by
design (flash: uniform average of V, dense: 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lip2speech_tpu.ops import nn as jops
from lip2speech_tpu.ops import pallas_rel_attention as jra
from lip2speech_tpu_torch.ops import rel_attention as tra


def _inputs(t, lens, seed=1, b=2, h=2, dk=16):
    rng = np.random.default_rng(seed)
    q_u, q_v, k, v = (rng.standard_normal((b, h, t, dk)).astype(np.float32)
                      for _ in range(4))
    pe = jops.sinusoidal_rel_pos_encoding(t, h * dk)
    p = np.ascontiguousarray(pe.reshape(2 * t - 1, h, dk).transpose(1, 0, 2))
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    return q_u, q_v, k, v, p, mask


def _valid_rows_close(got, ref, mask, atol):
    for i in range(mask.shape[0]):
        np.testing.assert_allclose(got[i][:, mask[i]], ref[i][:, mask[i]], atol=atol)


@pytest.mark.parametrize("t,lens", [(12, [12, 7]), (40, [40, 33])])
def test_dense_matches_jax_dense(t, lens):
    args = _inputs(t, lens)
    ref = np.asarray(jra.dense_rel_attention(*map(jnp.asarray, args)))
    got = tra.dense_rel_attention(*map(torch.from_numpy, args)).numpy()
    _valid_rows_close(got, ref, args[-1], atol=1e-5)


@pytest.mark.parametrize("t,lens", [(12, [12, 7]), (40, [40, 33])])
def test_dense_matches_jax_flash_interpret(t, lens):
    args = _inputs(t, lens, seed=2)
    ref = np.asarray(jra.rel_flash_attention(*map(jnp.asarray, args), block=16,
                                             interpret=True))
    got = tra.rel_attention(*map(torch.from_numpy, args)).numpy()
    _valid_rows_close(got, ref, args[-1], atol=1e-5)


def test_rel_shift_matches_gather():
    x = torch.arange(3 * 5 * 9, dtype=torch.float32).reshape(3, 5, 9)
    out = tra.rel_shift(x)
    t = 5
    ref = torch.stack([torch.stack([x[:, i, t - 1 - i + j] for j in range(t)], -1)
                       for i in range(t)], 1)
    assert torch.equal(out, ref)


def test_kernel_launcher_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(12, [12, 7], dk=64)]
    before = tra.rel_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tra.rel_attention_kernel(*args)
    assert tra.rel_attention_kernel.launches == before
