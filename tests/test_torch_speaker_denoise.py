"""The port's speaker encoder (models/speaker.py, convert/from_jax.
speaker_state_dict, the `speaker` kind of cli/convert.py) and denoiser
(ops/denoise.py) against the JAX package's, on the CPU. Inputs from numpy
seeds; float results within 1e-5 of max |ref|, conversions exact."""

import sys

import numpy as np
import pytest
import torch

import jax

from lip2speech_tpu.cli import convert as jconvert_cli
from lip2speech_tpu.models import speaker as jspeaker
from lip2speech_tpu.ops import denoise as jdenoise
from lip2speech_tpu.train.checkpoint import load_pytree
from lip2speech_tpu_torch.cli import convert as tconvert_cli
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.models import speaker as tspeaker
from lip2speech_tpu_torch.ops import denoise as tdenoise
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

REL_TOL = 1e-5


def speaker_params(seed: int) -> dict:
    """A GE2E parameter tree in the JAX layout (init_params' shapes and
    ranges), drawn with numpy: jax.random's eager draws cost ~2 s."""
    rng = np.random.default_rng(seed)
    h, s = tspeaker.EMBED_DIM, 1 / np.sqrt(tspeaker.EMBED_DIM)
    u = lambda *shape: rng.uniform(-s, s, shape).astype(np.float32)  # noqa: E731
    params = {f"lstm_{k}": {"w_ih": u(4 * h, tspeaker.MEL_CHANNELS if k == 0 else h),
                            "w_hh": u(4 * h, h), "b_ih": u(4 * h), "b_hh": u(4 * h)}
              for k in range(tspeaker.LSTM_LAYERS)}
    params["linear"] = {"weight": u(h, tspeaker.EMBED_DIM), "bias": u(tspeaker.EMBED_DIM)}
    return params


def encoder_from(params) -> tspeaker.SpeakerEncoder:
    enc = tspeaker.SpeakerEncoder()
    enc.load_state_dict(from_jax.speaker_state_dict(params))
    return enc


def _wav(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * 220 * t / 16_000) * np.sin(2 * np.pi * 3 * t / 16_000)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


# frame counts 1 + n // 128: 126 (even; the 20th percentile interpolates
# between two magnitudes), 129, 55; strength 1.5 (the server's) and 3.0
@pytest.mark.parametrize("n,strength", [(16_000, 1.5), (16_384, 1.5), (7_000, 3.0)])
def test_spectral_gate_matches_jax(n, strength):
    wav = _wav(n, seed=n)
    ref = np.asarray(jdenoise.spectral_gate(wav, strength))
    got = tdenoise.spectral_gate(torch.from_numpy(wav), strength).numpy()
    assert got.shape == ref.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=REL_TOL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("kind", ["speech", "silence"])
def test_preprocess_audio_matches_jax(kind):
    wav = _wav(12_000, seed=1) * 0.1 if kind == "speech" else np.zeros(12_000, np.float32)
    ref = jdenoise.preprocess_audio(wav)
    got = tdenoise.preprocess_audio(torch.from_numpy(wav)).numpy()
    if kind == "silence":
        np.testing.assert_array_equal(got, ref)
    else:
        assert abs(np.abs(got).max() - 0.95) < 1e-6
        np.testing.assert_allclose(got, ref, atol=REL_TOL * np.abs(ref).max(), rtol=0)


def test_speaker_state_dict_layout_and_partial_slices():
    params = speaker_params(0)
    sd = from_jax.speaker_state_dict(params)
    assert set(sd) == set(tspeaker.SpeakerEncoder().state_dict())
    np.testing.assert_array_equal(sd["linear.weight"].numpy(), params["linear"]["weight"].T)
    np.testing.assert_array_equal(sd["lstm.weight_hh_l2"].numpy(), params["lstm_2"]["w_hh"])
    for n in (1, 100, 160, 161, 239, 240, 241, 1000):
        assert tspeaker.compute_partial_slices(n) == jspeaker.compute_partial_slices(n)


# 8,000 samples: one short partial (51 frames); 16,000: one (101);
# 48,000: 301 frames, four 160-frame partials batched in one LSTM call
@pytest.mark.parametrize("n", [8_000, 16_000, 48_000])
def test_embed_utterance_matches_jax(n):
    params = speaker_params(1)
    wav = _wav(n, seed=2)
    ref = jspeaker.embed_utterance(params, wav)
    got = tspeaker.embed_utterance(encoder_from(params), wav)
    assert got.shape == ref.shape == (256,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=REL_TOL * np.abs(ref).max(), rtol=0)
    mel_ref = np.asarray(jspeaker.speaker_mel(wav))
    mel = tspeaker.speaker_mel(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(mel, mel_ref, atol=REL_TOL * np.abs(mel_ref).max(), rtol=0)


def _rtvc_file(path):
    """An RTVC encoder.pt state_dict (nn.LSTM names, the GE2E similarity
    scalars beside them)."""
    torch.manual_seed(0)
    sd = dict(tspeaker.SpeakerEncoder().state_dict())
    sd.update(similarity_weight=torch.tensor([10.0]), similarity_bias=torch.tensor([-5.0]))
    torch.save(sd, path)
    return sd


def test_convert_rtvc_encoder_matches_jax(tmp_path):
    sd = _rtvc_file(tmp_path / "encoder.pt")
    ours = tspeaker.convert_rtvc_encoder(sd)
    theirs = from_jax.speaker_state_dict(jspeaker.convert_rtvc_encoder(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(ours) == set(theirs) == set(tspeaker.SpeakerEncoder().state_dict())
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    with pytest.raises(KeyError):
        tspeaker.convert_rtvc_encoder({k: v for k, v in sd.items() if k != "linear.bias"})


def test_convert_cli_speaker_kind_matches_jax(tmp_path, monkeypatch):
    _rtvc_file(tmp_path / "encoder.pt")
    monkeypatch.setattr(sys, "argv", ["convert", "--kind", "speaker", "--input",
                                      str(tmp_path / "encoder.pt"), "--output",
                                      str(tmp_path / "jax_speaker")])
    jconvert_cli.main()
    theirs = from_jax.speaker_state_dict(
        jax.tree_util.tree_map(np.asarray, load_pytree(tmp_path / "jax_speaker")["params"]))
    tconvert_cli.main(["--kind", "speaker", "--input", str(tmp_path / "encoder.pt"),
                       "--output", str(tmp_path / "speaker.pt")])
    ours = torch.load(tmp_path / "speaker.pt", weights_only=True)["speaker"]
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    enc = tspeaker.SpeakerEncoder()
    enc.load_state_dict(ours)                       # strict: the encoder's own names
