"""The port's serving slices as a whole against the JAX pipeline (plain
path) at tiny width on the CPU, for each of the four stage-1 presets: one set
of weights made by flax, perturbed and carried across, a ragged batch of 2.
The frontend encoders are 2 layers of dim 64 (head dim 16: the plain
versions take any head dim)."""

import functools

import numpy as np
import pytest

import jax

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.pipeline.synthesise import Lip2SpeechPipeline as JaxPipeline
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline as TorchPipeline

from test_torch_modules import _perturb

EMB = 8


def _cfg(c, kind="resnet3d"):
    voc = c.VocoderConfig(model_in_dim=80 + 2 * EMB, embedding_dim=EMB,
                          upsample_initial_channel=32)
    if kind == "resnet3d":
        frontend, input_dim = c.FrontendConfig(), 512
    else:
        frontend, input_dim = c.FrontendConfig(
            kind=kind, frozen=True, encoder_dim=64, encoder_heads=4, encoder_ffn_dim=128,
            encoder_layers=2), 64
    conformer = c.ConformerConfig(dim=64, ffn_dim=128, heads=4, layers=2, conv_kernel=7,
                                  input_dim=input_dim)
    return c.PipelineConfig(model=c.MultiTargetConfig(frontend=frontend, conformer=conformer),
                            vocoder=voc)


@functools.lru_cache(maxsize=None)
def _weights(kind):
    jp = JaxPipeline.initialize_random(_cfg(jcfg, kind), seed=0, frames=4)
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


@pytest.mark.parametrize("kind,emit_int16", [
    pytest.param("resnet3d", False, id="False"), pytest.param("resnet3d", True, id="True"),
    pytest.param("avhubert", False, id="avhubert-False"),
    pytest.param("avhubert", True, id="avhubert-True"),
    pytest.param("auto_avsr", False, id="auto_avsr-False"),
    pytest.param("raven", False, id="raven-False"),
])
def test_pipeline_matches_jax(request_batch, kind, emit_int16):
    s1, voc = _weights(kind)
    jax_s1 = jax.tree_util.tree_map(np.asarray, s1)
    ref = JaxPipeline(_cfg(jcfg, kind), jax_s1, voc, emit_int16=emit_int16).synthesise_batch(
        *request_batch)
    got = TorchPipeline.from_jax_variables(_cfg(tcfg, kind), s1, voc, emit_int16=emit_int16,
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


def test_presets_match_the_jax_presets():
    import dataclasses

    for name in ("multi_target", "multi_target_avhubert", "multi_target_auto_avsr",
                 "multi_target_raven", "tiny"):
        ours, theirs = tcfg.preset(name).model, jcfg.preset(name).model
        for part in ("frontend", "conformer", "units"):
            for f in dataclasses.fields(getattr(ours, part)):
                assert getattr(getattr(ours, part), f.name) == getattr(getattr(theirs, part), f.name)
        for part in ("vocoder", "stage1"):
            ours, theirs = getattr(tcfg.preset(name), part), getattr(jcfg.preset(name), part)
            for f in dataclasses.fields(ours):
                assert getattr(ours, f.name) == getattr(theirs, f.name), (name, part, f.name)
    assert tcfg.with_overrides(tcfg.preset("tiny"), {"stage1.batch_size": 5}).stage1.batch_size == 5
    with pytest.raises(ValueError, match="unknown preset"):
        tcfg.preset("tiny_and_unknown")
