"""Port modules (lip2speech_tpu_torch/models) against their flax counterparts:
weights made by flax, perturbed (BatchNorm statistics, weight-norm gains) so
that no part of the math is trivial, carried across by
lip2speech_tpu_torch/convert/from_jax.py, same numpy inputs on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.models import conformer as jconf
from lip2speech_tpu.models import multi_target as jmt
from lip2speech_tpu.models import resnet3d as jres
from lip2speech_tpu.models import vocoder as jvoc
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.models import conformer as tconf
from lip2speech_tpu_torch.models import multi_target as tmt
from lip2speech_tpu_torch.models import resnet3d as tres
from lip2speech_tpu_torch.models import vocoder as tvoc

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _perturb(variables, seed=0):
    """Non-trivial BN running statistics, weight-norm gains of order 1, PReLU
    alphas (the weight of a module named act*) and layerscale gammas."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif k.startswith("gamma_") or (k == "weight" and name.startswith("act")):
                out[k] = rng.uniform(0.05, 0.5, v.shape).astype(np.float32)
            elif k == "running_mean":
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "running_var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k == "weight_g":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(_np_tree(variables))


def _load(module, variables):
    sd = from_jax.jax_tree_to_state_dict(variables.get("params", {}))
    sd.update(from_jax.jax_tree_to_state_dict(variables.get("batch_stats", {})))
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _close(got: torch.Tensor, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_resnet3d_frontend():
    rng = np.random.default_rng(0)
    video = rng.standard_normal((2, 3, 88, 88, 1)).astype(np.float32)
    jm = jres.ResNet3DFrontend()
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(video)))
    ref = jm.apply(v, jnp.asarray(video))
    got = _load(tres.ResNet3DFrontend(), v)(torch.from_numpy(video))
    assert got.shape == (2, 3, 512)
    _close(got, ref)


def test_conformer_encoder_two_layers():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 48)).astype(np.float32)
    mask = np.arange(10)[None, :] < np.array([[10], [7]])
    jm = jconf.ConformerEncoder(dim=64, ffn_dim=128, heads=4, layers=2, conv_kernel=7)
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask)))
    ref, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    tm = _load(tconf.ConformerEncoder(48, 64, 128, 4, 2, 7), v)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, ref)


def test_unit_and_mel_heads():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    spk = rng.standard_normal((2, 256)).astype(np.float32)
    jmlp, jmel = jmt.MLPHead(64, 204), jmt.MelHead(64)
    vmlp = _perturb(jmlp.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    vmel = _perturb(jmel.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(spk)))
    _close(_load(tmt.MLPHead(64, 204), vmlp)(torch.from_numpy(x)),
           jmlp.apply(vmlp, jnp.asarray(x)))
    got = _load(tmt.MelHead(64), vmel)(torch.from_numpy(x), torch.from_numpy(spk))
    assert got.shape == (2, 12, 80)
    _close(got, jmel.apply(vmel, jnp.asarray(x), jnp.asarray(spk)))


def test_interleave_time():
    x = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    np.testing.assert_array_equal(tmt.interleave_time(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jmt.interleave_time(jnp.asarray(x), 2)))


@pytest.mark.parametrize("kernels,dilations", [
    ((3,), ((1, 3, 5),)),
    ((3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))),
])
def test_vocoder_generator(kernels, dilations):
    emb = 8
    kw = dict(model_in_dim=80 + 2 * emb, embedding_dim=emb, upsample_initial_channel=32,
              resblock_kernel_sizes=kernels, resblock_dilation_sizes=dilations)
    rng = np.random.default_rng(3)
    tc = 6
    code = rng.integers(0, 200, (2, tc)).astype(np.int32)
    mel = rng.standard_normal((2, 2 * tc, 80)).astype(np.float32)
    spk = rng.standard_normal((2, 256)).astype(np.float32)
    jm = jvoc.MelCodeGenerator(jcfg.VocoderConfig(**kw))
    v = _perturb(jm.init(jax.random.PRNGKey(4), jnp.asarray(code), jnp.asarray(mel),
                         jnp.asarray(spk)))
    ref = jm.apply(v, jnp.asarray(code), jnp.asarray(mel), jnp.asarray(spk))
    tm = _load(tvoc.MelCodeGenerator(tcfg.VocoderConfig(**kw)), v)
    got = tm(torch.from_numpy(code).long(), torch.from_numpy(mel), torch.from_numpy(spk))
    assert got.shape == (2, 320 * tc)
    assert float(got.detach().abs().max()) > 0.05  # the gains make the wav non-trivial
    _close(got, ref)
