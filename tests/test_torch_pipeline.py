"""The port's multi_target slice as a whole against the JAX pipeline (plain
path) at tiny width on the CPU: one set of weights made by flax and carried
across, a ragged batch of 2."""

import numpy as np
import pytest

import jax

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.pipeline.synthesise import Lip2SpeechPipeline as JaxPipeline
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline as TorchPipeline

from test_torch_modules import _perturb

EMB = 8


def _cfg(c):
    voc = c.VocoderConfig(model_in_dim=80 + 2 * EMB, embedding_dim=EMB,
                          upsample_initial_channel=32)
    conformer = c.ConformerConfig(dim=64, ffn_dim=128, heads=4, layers=2, conv_kernel=7)
    return c.PipelineConfig(model=c.MultiTargetConfig(conformer=conformer), vocoder=voc)


@pytest.fixture(scope="module")
def weights():
    jp = JaxPipeline.initialize_random(_cfg(jcfg), seed=0, frames=4)
    s1 = _perturb(jp.stage1_variables, seed=1)
    voc = _perturb({"params": jp.vocoder_params}, seed=2)["params"]
    return s1, voc


@pytest.fixture(scope="module")
def request_batch():
    rng = np.random.default_rng(0)
    video = rng.standard_normal((2, 6, 88, 88, 1)).astype(np.float32)
    mask = np.arange(6)[None, :] < np.array([[6], [4]])
    spk = rng.standard_normal((2, 256)).astype(np.float32)
    return video, mask, spk


@pytest.mark.parametrize("emit_int16", [False, True])
def test_pipeline_matches_jax(weights, request_batch, emit_int16):
    s1, voc = weights
    jax_s1 = jax.tree_util.tree_map(np.asarray, s1)
    ref = JaxPipeline(_cfg(jcfg), jax_s1, voc, emit_int16=emit_int16).synthesise_batch(
        *request_batch)
    got = TorchPipeline.from_jax_variables(_cfg(tcfg), s1, voc, emit_int16=emit_int16,
                                           device="cpu").synthesise_batch(*request_batch)
    assert len(got) == len(ref) == 2
    for g, r, n in zip(got, ref, (6, 4)):
        assert g.units.shape == (2 * n,) and g.wav.shape == (640 * n,)
        np.testing.assert_array_equal(g.units, r.units)
        assert g.wav.dtype == r.wav.dtype and g.mel.dtype == r.mel.dtype
        if emit_int16:
            diff = np.abs(g.wav.astype(np.int32) - r.wav.astype(np.int32))
            assert diff.max() <= 1 and np.abs(r.wav).max() > 1000
            np.testing.assert_allclose(g.mel.astype(np.float32), r.mel.astype(np.float32),
                                       atol=5e-3)   # f16 wire format: one f16 ulp at |mel|~4
        else:
            np.testing.assert_allclose(g.wav, r.wav, atol=2e-4, rtol=0)
            np.testing.assert_allclose(g.mel, r.mel, atol=5e-4, rtol=0)
