"""The port's masked-prediction pretraining (lip2speech_tpu_torch/ops/
masking.py, models/avhubert_pretrain.py, convert/from_jax.pretrain_state_dict)
against the JAX package on the CPU.

The span masks must equal JAX's bit for bit at one seed. The model runs at a
tiny width (dim 32, 2 heads, ffn 64, 2 layers, final_dim 16, 12 classes; the
ResNet3D frontend at its fixed width on 24 x 24 crops) on weights made with
numpy over jax.eval_shape of a video-only init (so the audio parameters must
exist without audio at init) and carried across by the converter: logits,
the feature penalty, the loss and its logs within 1e-4 of max |ref|, and
the gradients of pretrain_loss by name within 1e-4 of the largest gradient
element, in eval mode and in training mode at dropout 0 (BatchNorm on the
batch statistics, its running statistics against flax's mutable
batch_stats). Modality dropout's uniform pair is set by the test on both
sides. The JAX half runs once a test run (run_once)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.models import avhubert_pretrain as jpre
from lip2speech_tpu.ops import masking as jmask
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.models import avhubert_pretrain as tpre
from lip2speech_tpu_torch.models.layers import init_weights
from lip2speech_tpu_torch.ops import masking as tmask

from test_torch_asr import run_once

TOL = 1e-4
DIMS = dict(dim=32, heads=2, ffn_dim=64, layers=2, final_dim=16, num_classes=12)
AV = dict(audio_feat_dim=104, modality_dropout=0.5, audio_dropout=0.5, dropout=0.0)
B, T, HW = 2, 8, 24
KEEP, DROP_AUDIO, DROP_VIDEO = (0.9, 0.1), (0.1, 0.2), (0.1, 0.8)   # (r_mod, r_aud)
CASES = {                                     # name: (modalities, train, uniform pair)
    "av_eval": ("av", False, None), "av_train": ("av", True, KEEP),
    "video_eval": ("v", False, None), "audio_eval": ("a", False, None),
    "drop_audio": ("av", True, DROP_AUDIO), "drop_video": ("av", True, DROP_VIDEO),
}
GRAD_CASES = ("av_eval", "av_train")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    video = rng.standard_normal((B, T, HW, HW, 1)).astype(np.float32)
    audio = rng.standard_normal((B, T, 104)).astype(np.float32)
    frames_mask = np.arange(T)[None, :] < np.array([[T], [T - 3]])
    span = jmask.compute_mask_indices((B, T), frames_mask.astype(np.int32), 0.5, 3, rng)
    targets = rng.integers(0, 12, (B, T)).astype(np.int32)
    return video, audio, frames_mask, span, targets


def _random_variables(tree, rng):
    """numpy values for an abstract flax tree: fan-in-scaled weights, norm
    scales and PReLU alphas of order 1, non-trivial BN statistics."""
    def fill(name, x):
        if name == "weight" and len(x.shape) >= 2:
            return rng.normal(0, 1 / np.sqrt(np.prod(x.shape[:-1])), x.shape)
        if name in ("weight", "running_var"):
            return rng.uniform(0.5, 1.5, x.shape)
        if name == "label_embs":
            return rng.normal(0, 1.0, x.shape)
        return rng.normal(0, 0.1 if name == "running_mean" else 0.05, x.shape)

    return {k: _random_variables(v, rng) if isinstance(v, dict)
            else fill(k, v).astype(np.float32) for k, v in tree.items()}


def _variables(seed=0):
    video, _, frames_mask, span, _ = _inputs()
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jpre.AVHubertPretrainModel(**DIMS, **AV).init(
        {"params": k, "dropout": k}, jnp.asarray(video), jnp.asarray(frames_mask),
        jnp.asarray(span), train=False))                 # video only: no audio at init
    return _random_variables(dict(shapes), np.random.default_rng(seed))


@contextlib.contextmanager
def _uniform_pair(pair):
    """Modality dropout's (r_mod, r_aud) on both sides: jax.random.uniform and
    torch.rand of shape (2,) return the pair."""
    if pair is None:
        yield
        return
    real_j, real_t = jax.random.uniform, torch.rand

    def fake_j(key, shape=(), *args, **kwargs):
        return jnp.asarray(pair, jnp.float32) if tuple(shape) == (2,) else real_j(key, shape, *args, **kwargs)

    def fake_t(*size, **kwargs):
        if size == (2,):
            return torch.tensor(pair, device=kwargs.get("device"))
        return real_t(*size, **kwargs)

    jax.random.uniform, torch.rand = fake_j, fake_t
    try:
        yield
    finally:
        jax.random.uniform, torch.rand = real_j, real_t


def _modalities(mods, video, audio, span, lib):
    vid = (jpre.mask_video_frames(jnp.asarray(video), jnp.asarray(span)) if lib == "jax"
           else tpre.mask_video_frames(torch.from_numpy(video), torch.from_numpy(span)))
    aud = jnp.asarray(audio) if lib == "jax" else torch.from_numpy(audio)
    return (vid if "v" in mods else None), (aud if "a" in mods else None)


def _jax_case(variables, mods, train, pair, grads: bool):
    video, audio, frames_mask, span, targets = _inputs()
    jm = jpre.AVHubertPretrainModel(**DIMS, **AV)
    vid, aud = _modalities(mods, video, audio, span, "jax")
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        v = {"params": params, **rest}
        if train:
            out, upd = jm.apply(v, vid, jnp.asarray(frames_mask), jnp.asarray(span), train=True,
                                audio=aud, rngs={"dropout": jax.random.PRNGKey(1)},
                                mutable=["batch_stats"])
        else:
            out, upd = jm.apply(v, vid, jnp.asarray(frames_mask), jnp.asarray(span), audio=aud), {}
        loss, logs = jpre.pretrain_loss(out, jnp.asarray(targets))
        return loss, (out, logs, upd)

    with _uniform_pair(pair):
        if grads:
            (loss, (out, logs, upd)), g = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        else:
            (loss, (out, logs, upd)), g = loss_fn(variables["params"]), None
    res = {"logits": np.asarray(out["logits"]), "features_pen": float(out["features_pen"]),
           "loss": float(loss), "logs": {k: float(v) for k, v in logs.items()},
           "batch_stats": jax.tree_util.tree_map(np.asarray, dict(upd).get("batch_stats", {}))}
    if g is not None:
        res["grads"] = {k: v.numpy() for k, v in from_jax.jax_tree_to_state_dict(
            jax.tree_util.tree_map(np.asarray, g)).items()}
    return res


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    def compute(_):
        variables = _variables()
        return {"variables": variables,
                "cases": {name: _jax_case(variables, mods, train, pair, name in GRAD_CASES)
                          for name, (mods, train, pair) in CASES.items()}}
    return run_once(tmp_path_factory, "pretrain_jax", compute)[1]


def _port(variables, train: bool):
    model = tpre.AVHubertPretrainModel(**DIMS, **AV)
    model.load_state_dict(from_jax.pretrain_state_dict(variables), strict=True)
    return model.train(train)


def _port_case(model, mods, pair):
    video, audio, frames_mask, span, targets = _inputs()
    vid, aud = _modalities(mods, video, audio, span, "torch")
    with _uniform_pair(pair):
        out = model(vid, torch.from_numpy(frames_mask), torch.from_numpy(span), audio=aud)
    loss, logs = tpre.pretrain_loss(out, torch.from_numpy(targets))
    return out, loss, logs


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), 1e-30)
    assert err <= TOL * scale, f"{what}: max err {err:.3e} of max |ref| {scale:.3e}"


# ------------------------------------------------------------------ masks

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("padding", ["none", "bool", "int", "short_row"])
def test_compute_mask_indices_bit_for_bit(seed, padding):
    b, t = 4, 60
    lens = np.array([60, 41, 17, 3 if padding == "short_row" else 9])   # 3 < mask_length
    valid = np.arange(t)[None, :] < lens[:, None]
    pad = {"none": None, "bool": ~valid, "int": valid.astype(np.int32),
           "short_row": valid.astype(np.float32)}[padding]
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = jmask.compute_mask_indices((b, t), pad, 0.4, 5, rj)
    got = tmask.compute_mask_indices((b, t), pad, 0.4, 5, rt)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.bool_ and got.any()
    assert rj.bit_generator.state == rt.bit_generator.state      # the same draws, in order
    if pad is not None:
        assert not (got & ~valid).any()
    if padding == "short_row":
        assert not got[3].any()


def test_mask_video_frames_is_exact():
    video, _, _, span, _ = _inputs(3)
    ref = np.asarray(jpre.mask_video_frames(jnp.asarray(video), jnp.asarray(span)))
    got = tpre.mask_video_frames(torch.from_numpy(video), torch.from_numpy(span)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[span].any() and np.array_equal(got[~span], video[~span])


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("case", list(CASES))
def test_pretrain_forward_and_loss_match_jax(jax_ref, case):
    mods, train, pair = CASES[case]
    ref = jax_ref["cases"][case]
    model = _port(jax_ref["variables"], train)
    out, loss, logs = _port_case(model, mods, pair)
    assert out["logits"].shape == (B, T, DIMS["num_classes"])
    _close(out["logits"].detach(), ref["logits"], f"{case} logits")
    _close(float(out["features_pen"].detach()), ref["features_pen"], f"{case} features_pen")
    _close(float(loss.detach()), ref["loss"], f"{case} loss")
    assert set(logs) == set(ref["logs"])
    for k, v in logs.items():
        _close(float(v), ref["logs"][k], f"{case} {k}")
    if train:
        stats = from_jax.jax_tree_to_state_dict(ref["batch_stats"])
        sd = model.state_dict()
        assert stats and all(k in sd for k in stats)
        for k, v in stats.items():
            _close(sd[k], v.numpy(), f"{case} {k}")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_pretrain_gradients_match_jax_by_name(jax_ref, case):
    mods, train, pair = CASES[case]
    ref = jax_ref["cases"][case]["grads"]
    model = _port(jax_ref["variables"], train)
    _, loss, _ = _port_case(model, mods, pair)
    loss.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref)
    top = max(np.abs(g).max() for g in ref.values())
    for n, g in ref.items():
        err = np.abs(got[n] - g).max()
        assert err <= TOL * top, f"{case} {n}: max err {err:.3e} of the largest element {top:.3e}"
    assert np.abs(got["mask_emb"]).max() > 0 and np.abs(got["label_embs"]).max() > 0


def test_modality_dropout_outcomes(jax_ref):
    """The three outcomes differ (each equals JAX's in
    test_pretrain_forward_and_loss_match_jax: av_train, drop_audio,
    drop_video), and dropping a modality equals not giving it."""
    cases = jax_ref["cases"]
    keep, drop_a, drop_v = (cases[c]["logits"] for c in ("av_train", "drop_audio", "drop_video"))
    assert min(np.abs(keep - drop_a).max(), np.abs(keep - drop_v).max(),
               np.abs(drop_a - drop_v).max()) > 1e-3
    with torch.no_grad():
        for pair, alone in ((DROP_AUDIO, "v"), (DROP_VIDEO, "a")):
            dropped = _port_case(_port(jax_ref["variables"], True), "av", pair)[0]["logits"]
            given = _port_case(_port(jax_ref["variables"], True), alone, None)[0]["logits"]
            torch.testing.assert_close(dropped, given, rtol=0, atol=1e-6)


def test_mask_emb_is_live_at_the_masked_positions(jax_ref):
    """Masked audio frames are replaced by mask_emb inside the model: their
    values do not reach the output, mask_emb does."""
    video, audio, frames_mask, span, _ = _inputs()
    model = _port(jax_ref["variables"], False)
    args = (tpre.mask_video_frames(torch.from_numpy(video), torch.from_numpy(span)),
            torch.from_numpy(frames_mask), torch.from_numpy(span))
    with torch.no_grad():
        base = model(*args, audio=torch.from_numpy(audio))["logits"]
        other = np.where(span[:, :, None], audio + 5.0, audio).astype(np.float32)
        same = model(*args, audio=torch.from_numpy(other))["logits"]
        model.mask_emb.add_(1.0)
        moved = model(*args, audio=torch.from_numpy(audio))["logits"]
    assert span.any()
    assert torch.equal(base, same)
    assert float((moved - base).abs().max()) > 1e-4


def test_eight_adam_steps_lower_the_loss():
    """tests/test_pretrain.py's loop on the port, from the port's own init:
    eval mode, Adam 1e-3."""
    model = tpre.AVHubertPretrainModel(**DIMS, **AV)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    assert float(model.label_embs.detach().min()) >= 0.0 and float(model.mask_emb.detach().max()) < 1.0
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    _, l0, logs = _port_case(model, "v", None)
    assert np.isfinite(float(l0)) and int(logs["n_masked"]) > 0
    for _ in range(8):
        opt.zero_grad()
        _port_case(model, "v", None)[1].backward()
        opt.step()
    _, l1, _ = _port_case(model, "v", None)
    assert float(l1) < float(l0)


def test_pretrain_converter_is_strict(jax_ref):
    variables = jax_ref["variables"]
    model = tpre.AVHubertPretrainModel(**DIMS, **AV)
    extra = {**variables, "params": {**variables["params"], "stray": np.zeros(3, np.float32)}}
    with pytest.raises(RuntimeError, match="stray"):
        model.load_state_dict(from_jax.pretrain_state_dict(extra), strict=True)
    missing = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "mask_emb"}}
    with pytest.raises(RuntimeError, match="mask_emb"):
        model.load_state_dict(from_jax.pretrain_state_dict(missing), strict=True)
    with pytest.raises(KeyError, match="batch_stats"):
        from_jax.pretrain_state_dict({"params": variables["params"]})
    with pytest.raises(KeyError, match="vq_stats"):
        from_jax.pretrain_state_dict({**variables, "vq_stats": {}})
    with pytest.raises(ValueError, match="modality"):
        model(None, torch.ones(1, 2, dtype=torch.bool), torch.zeros(1, 2, dtype=torch.bool))
