"""Port's AV-HuBERT / HuBERT modules and unit extraction
(lip2speech_tpu_torch/models/{avhubert,hubert}.py, ops/kmeans.py,
pipeline/units_extract.py) against their flax counterparts: weights made by
flax, perturbed, carried across by convert/from_jax.py, same numpy inputs on
both sides. Tolerance 1e-4 (float32 on both sides; the summation order of
the convolutions and products differs)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.models import avhubert as jav
from lip2speech_tpu.models import conformer as jconf
from lip2speech_tpu.models import hubert as jhub
from lip2speech_tpu.models import resnet3d as jres
from lip2speech_tpu.ops import kmeans as jkm
from lip2speech_tpu.pipeline import units_extract as jue
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.models import avhubert as tav
from lip2speech_tpu_torch.models import conformer as tconf
from lip2speech_tpu_torch.models import hubert as thub
from lip2speech_tpu_torch.models import resnet3d as tres
from lip2speech_tpu_torch.ops import kmeans as tkm
from lip2speech_tpu_torch.pipeline import units_extract as tue

from test_torch_modules import _close, _load, _perturb

DIMS = dict(dim=64, heads=4, ffn_dim=128, layers=2)


def _video_and_mask(seed, b=2, t=4):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((b, t, 88, 88, 1)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [t - 2]])
    return rng, video, mask


def test_prelu_and_activation_factory():
    from lip2speech_tpu.ops import nn as jops
    from lip2speech_tpu_torch.models import layers as tlayers
    from lip2speech_tpu_torch.ops import nn as tops

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)         # channel-last for JAX
    alpha = rng.uniform(0.05, 0.5, 3).astype(np.float32)
    ref = np.asarray(jops.prelu(jnp.asarray(x), jnp.asarray(alpha)))
    got = tops.prelu(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    act = tlayers.activation("prelu", 3)
    tlayers.init_weights(act, torch.Generator().manual_seed(0))
    assert isinstance(act, tlayers.PReLU) and torch.all(act.weight == 0.25)
    assert tlayers.activation("swish") is tops.swish and tlayers.activation("gelu") is tops.gelu
    with pytest.raises(ValueError, match="unknown activation"):
        tlayers.activation("tanh")


def test_prelu_resnet3d_frontend():
    _, video, _ = _video_and_mask(0, t=3)
    jm = jres.ResNet3DFrontend(relu_type="prelu")
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(video)))
    assert v["params"]["trunk"]["layer1_0"]["act1"]["weight"].std() > 0   # alphas perturbed
    got = _load(tres.ResNet3DFrontend("prelu"), v)(torch.from_numpy(video))
    _close(got, jm.apply(v, jnp.asarray(video)))


@pytest.mark.parametrize("layer_norm_first", [True, False], ids=["pre_norm", "post_norm"])
def test_transformer_layer(layer_norm_first):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([[9], [6]])
    jm = jav.TransformerLayer(64, 4, 128, layer_norm_first=layer_norm_first)
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask)))
    tm = _load(tav.TransformerLayer(64, 4, 128, layer_norm_first), v)
    for m in (mask, None):
        ref = np.asarray(jm.apply(v, jnp.asarray(x), None if m is None else jnp.asarray(m)))
        got = tm(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        valid = mask if m is not None else np.ones_like(mask)
        _close(got[torch.from_numpy(valid)], ref[valid])


@pytest.mark.parametrize("kernel", [8, 7], ids=["even_kernel", "odd_kernel"])
def test_conv_positional_embedding(kernel):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    jm = jav.ConvPositionalEmbedding(32, kernel=kernel, groups=4)
    v = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    got = _load(tav.ConvPositionalEmbedding(32, kernel, 4), v)(torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got, jm.apply(v, jnp.asarray(x)))


def test_avhubert_encoder_video_only():
    _, video, mask = _video_and_mask(3)
    jm = jav.AVHubertEncoder(**DIMS)
    v = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(video), jnp.asarray(mask)))
    ref = np.asarray(jm.apply(v, jnp.asarray(video), jnp.asarray(mask)))
    got = _load(tav.AVHubertEncoder(**DIMS), v)(torch.from_numpy(video), torch.from_numpy(mask))
    assert got.shape == (2, 4, 64)
    _close(got[torch.from_numpy(mask)], ref[mask])


@pytest.mark.parametrize("modalities", ["audio", "both"])
def test_avhubert_encoder_with_audio(modalities):
    rng, video, mask = _video_and_mask(4)
    audio = rng.standard_normal((2, 4, 104)).astype(np.float32)
    jm = jav.AVHubertEncoder(**DIMS, audio_feat_dim=104)
    v = _perturb(jm.init(jax.random.PRNGKey(4), jnp.asarray(video), jnp.asarray(mask),
                         audio=jnp.asarray(audio)))
    tm = _load(tav.AVHubertEncoder(**DIMS, audio_feat_dim=104), v)
    jvideo, tvideo = ((None, None) if modalities == "audio"
                      else (jnp.asarray(video), torch.from_numpy(video)))
    ref = np.asarray(jm.apply(v, jvideo, jnp.asarray(mask), audio=jnp.asarray(audio)))
    got = tm(tvideo, torch.from_numpy(mask), audio=torch.from_numpy(audio))
    _close(got[torch.from_numpy(mask)], ref[mask])
    with pytest.raises(ValueError, match="video-only"):
        tav.AVHubertEncoder(**DIMS)(None, None, audio=torch.from_numpy(audio))


@pytest.mark.parametrize("kind", ["raven", "post_norm"])
def test_conformer_encoder_variants(kind):
    """RAVEn flags (no macaron, no conv module, layerscale, BatchNorm FFN
    pre-norms) and a post-norm macaron conformer."""
    flags = (dict(macaron=False, use_conv=False, layerscale=True, ff_bn_pre=True)
             if kind == "raven" else dict(normalize_before=False))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, 48)).astype(np.float32)
    mask = np.arange(10)[None, :] < np.array([[10], [7]])
    jm = jconf.ConformerEncoder(dim=64, ffn_dim=128, heads=4, layers=2, conv_kernel=7, **flags)
    v = _perturb(jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask)))
    ref, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(mask))
    tm = _load(tconf.ConformerEncoder(48, 64, 128, 4, 2, 7, **flags), v)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got[torch.from_numpy(mask)], np.asarray(ref)[mask])
    again = tm(torch.from_numpy(x), torch.from_numpy(mask))     # cached position table
    assert torch.equal(got, again) and len(tm._pos_tables) == 1


@pytest.mark.parametrize("output_layer", [None, 2, 0])
def test_hubert_base(output_layer):
    rng = np.random.default_rng(6)
    wav = rng.standard_normal((2, 4000)).astype(np.float32)
    jm = jhub.HubertBase(dim=64, heads=4, ffn_dim=128, layers=3)
    v = _perturb(jm.init(jax.random.PRNGKey(6), jnp.asarray(wav)))
    tm = thub.HubertBase(64, 4, 128, 3)
    tm.load_state_dict(from_jax.hubert_state_dict(v["params"]), strict=True)
    got = tm.eval()(torch.from_numpy(wav), output_layer=output_layer)
    assert got.shape == (2, 12, 64)          # 4000 samples through the unpadded convs
    _close(got, jm.apply(v, jnp.asarray(wav), output_layer=output_layer))


def _clustered(rng, n, k, d):
    centres = rng.standard_normal((k, d)).astype(np.float32) * 4.0
    return (centres[rng.integers(0, k, n)] + rng.standard_normal((n, d)).astype(np.float32))


def test_kmeans_assign_and_apply():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((300, 24)).astype(np.float32)
    cents = rng.standard_normal((20, 24)).astype(np.float32)
    ref = np.asarray(jkm.assign(jnp.asarray(feats), jnp.asarray(cents)))
    got = tkm.assign(torch.from_numpy(feats), torch.from_numpy(cents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    chunked = tkm.kmeans_apply(feats, cents, chunk=128, device="cpu")
    assert chunked.dtype == np.int32
    np.testing.assert_array_equal(chunked, jkm.kmeans_apply(feats, cents, chunk=128))
    assert tkm.kmeans_apply(feats[:0], cents, device="cpu").shape == (0,)


def test_kmeans_fit_matches_jax(tmp_path):
    data = _clustered(np.random.default_rng(8), 600, 8, 16)
    kw = dict(n_clusters=8, batch_size=200, n_steps=12, seed=3)
    ref = jkm.kmeans_fit(data, **kw)
    got = tkm.kmeans_fit(data, **kw, device="cpu")
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    tkm.save_km(tmp_path / "km.npy", got)
    np.testing.assert_array_equal(tkm.load_km(tmp_path / "km.npy"), got)
    with pytest.raises(ValueError, match="need >= 8"):
        tkm.kmeans_fit(data[:5], **kw, device="cpu")


@pytest.fixture(scope="module")
def hubert_params():
    """Full-width HubertBase params from flax (the extractors fix the size)."""
    v = jhub.HubertBase().init(jax.random.PRNGKey(9), jnp.zeros((1, 800)), output_layer=6)
    return jax.tree_util.tree_map(np.asarray, dict(v["params"]))


def test_feature_extractor_chunks_like_jax(hubert_params, monkeypatch):
    """The tree holds layers 0..5 only (initialised at output_layer=6): the
    extractor builds as many layers as the state holds."""
    wav = np.random.default_rng(9).standard_normal(2400).astype(np.float32)
    monkeypatch.setattr(jue, "MAX_CHUNK", 1600)
    monkeypatch.setattr(tue, "MAX_CHUNK", 1600)
    ref = jue.HubertFeatureExtractor(hubert_params).features(wav)
    ext = tue.HubertFeatureExtractor.from_jax_params(hubert_params, device="cpu")
    got = ext.features(wav)
    assert got.shape == ref.shape == (4 + 2, 768)        # chunks of 1600 and 800 samples
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert ext.features(wav[:0]).shape == (0, 768) and ext.model.n_layers == 6
    with pytest.raises(ValueError, match="need 9"):
        tue.HubertFeatureExtractor.from_jax_params(hubert_params, layer=9, device="cpu")


def test_manifest_and_wav_io_match_the_jax_package(tmp_path):
    from lip2speech_tpu.data import manifest as jman
    from lip2speech_tpu.utils import audio_io as jio
    from lip2speech_tpu_torch.data import manifest as tman
    from lip2speech_tpu_torch.utils import audio_io as tio

    rng = np.random.default_rng(12)
    for name, data in (("mono", rng.uniform(-1, 1, 400)), ("stereo", rng.uniform(-1, 1, (400, 2)))):
        jio.write_wav(tmp_path / f"{name}.wav", data, 16_000)
        ref, got = jio.read_wav(tmp_path / f"{name}.wav"), tio.read_wav(tmp_path / f"{name}.wav")
        assert got[1] == ref[1] == 16_000 and got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], ref[0])
    utts = [jman.Utterance(f"u{i}", tmp_path / f"video/u{i}.mp4", tmp_path / f"audio/u{i}.wav",
                           10 + i, 6400 + i) for i in range(3)]
    jman.write_manifest(tmp_path / "m.tsv", tmp_path, utts)
    rows = [rng.integers(0, 200, 4 + i) for i in range(3)]
    tman.write_units(tmp_path / "m.unt", rows)
    assert (tmp_path / "m.unt").read_text() == "\n".join(
        " ".join(map(str, r)) for r in rows) + "\n"
    for ours, theirs in zip(tman.read_manifest(tmp_path / "m.tsv", tmp_path / "m.unt"),
                            jman.read_manifest(tmp_path / "m.tsv", tmp_path / "m.unt")):
        assert (ours.uid, ours.video_path, ours.audio_path, ours.n_frames, ours.n_samples) == (
            theirs.uid, theirs.video_path, theirs.audio_path, theirs.n_frames, theirs.n_samples)
        np.testing.assert_array_equal(ours.units, theirs.units)
    assert tman.read_manifest(tmp_path / "m.tsv", root_override="/data")[0].audio_path.parts[:2] \
        == ("/", "data")
    with pytest.raises(ValueError, match="label rows"):
        tman.write_units(tmp_path / "short.unt", rows[:2])
        tman.read_manifest(tmp_path / "m.tsv", tmp_path / "short.unt")


def test_label_manifest_writes_units(hubert_params, tmp_path):
    from lip2speech_tpu.utils.audio_io import write_wav
    from lip2speech_tpu_torch.data.manifest import read_manifest

    rng = np.random.default_rng(10)
    (tmp_path / "audio").mkdir()
    rows = [str(tmp_path)]
    for i, n in enumerate((1600, 1280)):
        write_wav(tmp_path / "audio" / f"u{i}.wav", rng.uniform(-0.5, 0.5, n), 16_000)
        rows.append(f"u{i}\tvideo/u{i}.mp4\taudio/u{i}.wav\t{n // 640}\t{n}")
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    ext = tue.HubertFeatureExtractor.from_jax_params(hubert_params, device="cpu")
    feats = tue.dump_features(ext, read_manifest(tmp_path / "train.tsv"))
    assert [f.shape for f in feats] == [(4, 768), (3, 768)]
    cents = np.concatenate(feats)[[0, 2, 5]]
    tue.label_manifest(ext, cents, tmp_path / "train.tsv", tmp_path / "train.unt")
    utts = read_manifest(tmp_path / "train.tsv", tmp_path / "train.unt")
    assert [u.units.tolist() for u in utts] == [
        tkm.kmeans_apply(f, cents, device="cpu").tolist() for f in feats]
    assert utts[0].units[0] == 0 and utts[0].units[2] == 1 and utts[1].units[1] == 2
