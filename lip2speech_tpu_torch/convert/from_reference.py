"""Published reference checkpoints (PyTorch .pt) -> the port's state_dicts
(the port's own copy of the JAX package's convert/torch_to_jax.py, chained
with convert/from_jax.py).

The module converters below build the JAX package's parameter trees from a
reference state_dict, as torch_to_jax does (numpy only); from_jax then moves
them into the port's names and layouts. So a reference checkpoint reaches
the port by the same layout moves the JAX package's converter tests trust.

Handles:
  * stage-1 fairseq checkpoints of all four variants (multi_target and its
    _avhubert, _auto_avsr, _raven frontends);
  * the vocoder's g_######## (generator) and do_######## (discriminators).

Weight layouts, torch -> JAX tree:
  Linear   (O,I)          -> (I,O)
  Conv1d   (O,I/g,K)      -> (K,I/g,O)
  Conv2d   (O,I,Kh,Kw)    -> (Kh,Kw,I,O)
  Conv3d   (O,I,Kt,Kh,Kw) -> (Kt,Kh,Kw,I,O)
  ConvT1d  (I,O,K)        -> (K,O,I)
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core.config import MultiTargetConfig, VocoderConfig
from lip2speech_tpu_torch.train import checkpoint

Array = np.ndarray
SD = Mapping[str, Array]


def unwrap(state: Any) -> dict[str, Array]:
    """A loaded reference checkpoint -> a flat {key: np.ndarray} dict: the
    fairseq envelope ("model") and the vocoder's g_ envelope ("generator")
    are taken off, and a do_ file's "mpd" and "msd" state_dicts are flattened
    under those prefixes (its optimizers, steps and epoch are left out)."""
    if isinstance(state, dict) and "model" in state:        # fairseq
        state = state["model"]
    if isinstance(state, dict) and "generator" in state and len(state) <= 3:
        state = state["generator"]                          # vocoder g_*
    if isinstance(state, dict) and isinstance(state.get("mpd"), dict):
        state = {f"{name}.{k}": v for name in ("mpd", "msd")   # vocoder do_*
                 for k, v in state[name].items()}
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in state.items()}


def _read(path: str | Path, full_unpickle: bool = False):
    """A checkpoint file's content, read weights-only (the port's files, the
    vocoder's g_ and do_). A file that pickles other objects (a fairseq
    checkpoint's config) is read in full only with full_unpickle, which runs
    whatever code the file names: the convert CLI's explicit import."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not full_unpickle:
            raise ValueError(
                f"{path} pickles objects besides tensors (a fairseq checkpoint's config); "
                "convert it first with `python -m lip2speech_tpu_torch.cli.convert`, "
                "which reads it in full") from e
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state(path: str | Path) -> dict[str, Array]:
    """A reference .pt checkpoint as a flat {key: np.ndarray} dict. The file
    is read in full (fairseq pickles its config): convert only files you
    trust."""
    return unwrap(_read(path, full_unpickle=True))


def fold_weight_norm(v: np.ndarray, g: np.ndarray, dim: int = 0) -> np.ndarray:
    """torch weight_norm's w = g * v / ||v||, the norm over every dim but `dim`."""
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
    return (g.reshape(norm.shape) / norm) * v


# ---------------------------------------------------------------------------
# primitive converters
# ---------------------------------------------------------------------------


def _lin(sd: SD, p: str) -> dict:
    out = {"weight": sd[f"{p}.weight"].T}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _conv1d(sd: SD, p: str) -> dict:
    out = {"weight": sd[f"{p}.weight"].transpose(2, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _conv2d_w(sd: SD, p: str) -> dict:
    out = {"weight": sd[f"{p}.weight"].transpose(2, 3, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _conv3d_w(sd: SD, p: str) -> dict:
    return {"weight": sd[f"{p}.weight"].transpose(2, 3, 4, 1, 0)}


def _ln(sd: SD, p: str) -> dict:
    return {"weight": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def _bn(sd: SD, p: str) -> tuple[dict, dict]:
    return ({"weight": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]},
            {"running_mean": sd[f"{p}.running_mean"],
             "running_var": sd[f"{p}.running_var"]})


def _wn_conv1d(sd: SD, p: str) -> dict:
    return {"weight_v": sd[f"{p}.weight_v"].transpose(2, 1, 0),
            "weight_g": sd[f"{p}.weight_g"].reshape(-1),
            "bias": sd[f"{p}.bias"]}


def _wn_conv2d(sd: SD, p: str) -> dict:
    return {"weight_v": sd[f"{p}.weight_v"].transpose(2, 3, 1, 0),
            "weight_g": sd[f"{p}.weight_g"].reshape(-1),
            "bias": sd[f"{p}.bias"]}


def _wn_convT1d(sd: SD, p: str) -> dict:
    # torch weight_norm(ConvTranspose1d) dim=0 = per INPUT channel
    return {"weight_v": sd[f"{p}.weight_v"].transpose(2, 1, 0),
            "weight_g": sd[f"{p}.weight_g"].reshape(-1),
            "bias": sd[f"{p}.bias"]}


def _plain_convT1d_as_wn(sd: SD, p: str) -> dict:
    """Wrap a plain ConvTranspose1d as (v, g) with g = per-in-channel norm so
    the composed weight equals the original."""
    w = sd[f"{p}.weight"].transpose(2, 1, 0)       # (K, O, I)
    g = np.sqrt((w ** 2).sum(axis=(0, 1)))
    return {"weight_v": w, "weight_g": g, "bias": sd[f"{p}.bias"]}


# ---------------------------------------------------------------------------
# module converters
# ---------------------------------------------------------------------------


def convert_resnet3d(sd: SD, p: str, prelu: bool) -> tuple[dict, dict]:
    """Reference Conv3dResNet/ResEncoder layout -> ResNet3DFrontend params.

    p is the prefix up to (and excluding) 'frontend3D' / 'trunk'.
    """
    params: dict = {"stem_conv": _conv3d_w(sd, f"{p}frontend3D.0")}
    stats: dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, f"{p}frontend3D.1")
    if prelu:
        params["act"] = {"weight": sd[f"{p}frontend3D.2.weight"]}
    trunk_p, trunk_s = {}, {}
    for stage in range(1, 5):
        for b in range(2):
            rp = f"{p}trunk.layer{stage}.{b}"
            name = f"layer{stage}_{b}"
            bp: dict = {"conv1": _conv2d_w(sd, f"{rp}.conv1"),
                        "conv2": _conv2d_w(sd, f"{rp}.conv2")}
            bs: dict = {}
            bp["bn1"], bs["bn1"] = _bn(sd, f"{rp}.bn1")
            bp["bn2"], bs["bn2"] = _bn(sd, f"{rp}.bn2")
            if prelu:
                bp["act1"] = {"weight": sd[f"{rp}.relu1.weight"]}
                bp["act2"] = {"weight": sd[f"{rp}.relu2.weight"]}
            if f"{rp}.downsample.0.weight" in sd:
                bp["downsample_conv"] = _conv2d_w(sd, f"{rp}.downsample.0")
                bp["downsample_bn"], bs["downsample_bn"] = _bn(sd, f"{rp}.downsample.1")
            trunk_p[name] = bp
            trunk_s[name] = bs
    params["trunk"] = trunk_p
    stats["trunk"] = trunk_s
    return params, stats


def convert_conformer_layers(sd: SD, p: str, n_layers: int,
                             macaron: bool = True, use_conv: bool = True,
                             layerscale: bool = False,
                             ff_bn_pre: bool = False) -> tuple[dict, dict]:
    """ESPnet `encoders.N.*` (+ after_norm/embed handled by caller).

    ff_bn_pre (RAVEn): the FFN pre-norms are BatchNorm1d with running stats.
    """
    params: dict = {}
    stats: dict = {}
    for i in range(n_layers):
        lp = f"{p}encoders.{i}"
        layer: dict = {
            "self_attn": {
                "linear_q": _lin(sd, f"{lp}.self_attn.linear_q"),
                "linear_k": _lin(sd, f"{lp}.self_attn.linear_k"),
                "linear_v": _lin(sd, f"{lp}.self_attn.linear_v"),
                "linear_out": _lin(sd, f"{lp}.self_attn.linear_out"),
                "linear_pos": _lin(sd, f"{lp}.self_attn.linear_pos"),
                "pos_bias_u": sd[f"{lp}.self_attn.pos_bias_u"],
                "pos_bias_v": sd[f"{lp}.self_attn.pos_bias_v"],
            },
            "feed_forward": {"w_1": _lin(sd, f"{lp}.feed_forward.w_1"),
                             "w_2": _lin(sd, f"{lp}.feed_forward.w_2")},
            "norm_mha": _ln(sd, f"{lp}.norm_mha"),
        }
        layer_stats: dict = {}
        if ff_bn_pre:
            layer["norm_ff"], layer_stats["norm_ff"] = _bn(sd, f"{lp}.norm_ff")
        else:
            layer["norm_ff"] = _ln(sd, f"{lp}.norm_ff")
        if macaron:
            layer["feed_forward_macaron"] = {
                "w_1": _lin(sd, f"{lp}.feed_forward_macaron.w_1"),
                "w_2": _lin(sd, f"{lp}.feed_forward_macaron.w_2")}
            if ff_bn_pre:
                layer["norm_ff_macaron"], layer_stats["norm_ff_macaron"] = _bn(
                    sd, f"{lp}.norm_ff_macaron")
            else:
                layer["norm_ff_macaron"] = _ln(sd, f"{lp}.norm_ff_macaron")
        if layer_stats:
            stats[f"layers_{i}"] = layer_stats
        if use_conv:
            # NOTE: the vendored ESPnet misspells "pointwise_cov{1,2}"
            layer["conv_module"] = {
                "pointwise_conv1": _conv1d(sd, f"{lp}.conv_module.pointwise_cov1"),
                "depthwise_conv": _conv1d(sd, f"{lp}.conv_module.depthwise_conv"),
                "pointwise_conv2": _conv1d(sd, f"{lp}.conv_module.pointwise_cov2"),
                "norm": _bn(sd, f"{lp}.conv_module.norm")[0],
            }
            layer_stats.setdefault("conv_module", {})["norm"] = _bn(
                sd, f"{lp}.conv_module.norm")[1]
            stats[f"layers_{i}"] = layer_stats
            if ff_bn_pre:
                layer["norm_conv"], layer_stats["norm_conv"] = _bn(sd, f"{lp}.norm_conv")
            else:
                layer["norm_conv"] = _ln(sd, f"{lp}.norm_conv")
            if f"{lp}.norm_final.weight" in sd:  # absent when post_norm=False
                layer["norm_final"] = _ln(sd, f"{lp}.norm_final")
        if layerscale:
            # raven layerscale gammas live directly on the layer
            # (raven/_espnet encoder_layer.py:113-127)
            for name in ["gamma_ff", "gamma_mha", "gamma_ff_macaron", "gamma_conv"]:
                key = f"{lp}.{name}"
                if key in sd:
                    layer[name] = sd[key]
        params[f"layers_{i}"] = layer
    return params, stats


def convert_espnet_encoder(sd: SD, p: str, n_layers: int) -> tuple[dict, dict]:
    """Full ESPnet conformer Encoder minus frontend: embed Linear + layers +
    after_norm -> our ConformerEncoder tree."""
    params, stats = convert_conformer_layers(sd, p, n_layers)
    params["embed"] = _lin(sd, f"{p}embed.0")
    params["after_norm"] = _ln(sd, f"{p}after_norm")
    return params, stats


def convert_mlp_head(sd: SD, p: str) -> dict:
    """Reference MLP (model.py:253-304): projection.0/.3 + last_layer."""
    return {"fc0": _lin(sd, f"{p}.projection.0"),
            "fc1": _lin(sd, f"{p}.projection.3"),
            "last": _lin(sd, f"{p}.last_layer")}


def convert_mel_head(sd: SD, p: str) -> dict:
    """mel_conv Sequential indices 0/3/6 + mel_proj (model.py:166-177)."""
    return {"conv0": _conv1d(sd, f"{p}mel_conv.0"),
            "conv1": _conv1d(sd, f"{p}mel_conv.3"),
            "conv2": _conv1d(sd, f"{p}mel_conv.6"),
            "proj": _lin(sd, f"{p}mel_proj")}


def convert_avhubert_video_encoder(sd: SD, p: str, n_layers: int = 24) -> tuple[dict, dict]:
    """AVHubertModel video-only path (avhubert/hubert.py:317-745) ->
    AVHubertVideoEncoder params. p = prefix of the AVHubertModel."""
    res_p, res_s = convert_resnet3d(sd, f"{p}feature_extractor_video.resnet.", prelu=True)
    params: dict = {
        "resnet": res_p,
        "video_proj": _lin(sd, f"{p}feature_extractor_video.proj"),
        "fuse_layer_norm": _ln(sd, f"{p}layer_norm"),
        "post_extract_proj": _lin(sd, f"{p}post_extract_proj"),
    }
    if f"{p}feature_extractor_audio.proj.weight" in sd:
        # audio SubModel (hubert.py:351): Linear(26x4 logfbank stack -> D)
        params["audio_proj"] = _lin(sd, f"{p}feature_extractor_audio.proj")
    stats = {"resnet": res_s}

    enc: dict = {}
    # pos_conv: weight_norm with dim=2 — fold it
    v = sd[f"{p}encoder.pos_conv.0.weight_v"]
    g = sd[f"{p}encoder.pos_conv.0.weight_g"]
    w = fold_weight_norm(v, g, dim=2)              # torch layout (O, I/g, K)
    enc["pos_conv"] = {"conv": {"weight": w.transpose(2, 1, 0),
                                "bias": sd[f"{p}encoder.pos_conv.0.bias"]}}
    for i in range(n_layers):
        lp = f"{p}encoder.layers.{i}"
        enc[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": _lin(sd, f"{lp}.self_attn.q_proj"),
                "k_proj": _lin(sd, f"{lp}.self_attn.k_proj"),
                "v_proj": _lin(sd, f"{lp}.self_attn.v_proj"),
                "out_proj": _lin(sd, f"{lp}.self_attn.out_proj"),
            },
            "self_attn_layer_norm": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "fc1": _lin(sd, f"{lp}.fc1"),
            "fc2": _lin(sd, f"{lp}.fc2"),
            "final_layer_norm": _ln(sd, f"{lp}.final_layer_norm"),
        }
    enc["layer_norm"] = _ln(sd, f"{p}encoder.layer_norm")
    params["encoder"] = enc
    return params, stats


def convert_multi_target(sd: SD, cfg: MultiTargetConfig) -> dict[str, Any]:
    """Stage-1 checkpoint -> {"params", "batch_stats"} for MultiTargetModel."""
    kind = cfg.frontend.kind
    params: dict = {}
    stats: dict = {}

    if kind == "resnet3d":
        head = "encoder."                      # MultiTargetEncoderModel.encoder = Conformer
        enc_p = f"{head}encoder."              # Conformer.encoder = espnet Encoder
        fe_p, fe_s = convert_resnet3d(sd, f"{enc_p}frontend.", prelu=False)
        params["frontend"] = fe_p
        stats["frontend"] = fe_s
    elif kind == "avhubert":
        head = "conformer."
        enc_p = f"{head}encoder."
        fe_p, fe_s = convert_avhubert_video_encoder(
            sd, "encoder.w2v_model.", cfg.frontend.encoder_layers)
        params["frontend"] = fe_p
        stats["frontend"] = fe_s
    elif kind in ("auto_avsr", "raven"):
        head = "conformer."
        enc_p = f"{head}encoder."
        fe_res_p, fe_res_s = convert_resnet3d(sd, "encoder.encoder.frontend.", prelu=False)
        params["frontend_resnet"] = fe_res_p
        stats["frontend_resnet"] = fe_res_s
        fe_enc_p, fe_enc_s = convert_conformer_layers(
            sd, "encoder.encoder.", cfg.frontend.encoder_layers,
            macaron=(kind == "auto_avsr"), use_conv=(kind == "auto_avsr"),
            layerscale=(kind == "raven"), ff_bn_pre=(kind == "raven"))
        fe_enc_p["embed"] = _lin(sd, "encoder.encoder.embed.0")
        fe_enc_p["after_norm"] = _ln(sd, "encoder.encoder.after_norm")
        params["frontend_encoder"] = fe_enc_p
        if fe_enc_s:
            stats["frontend_encoder"] = fe_enc_s
    else:
        raise ValueError(kind)

    conf_p, conf_s = convert_espnet_encoder(sd, enc_p, cfg.conformer.layers)
    if f"{head}proj_in.weight" in sd:
        # fold proj_in (frontend_dim -> 512) into the embed Linear (512 -> d):
        # two stacked linears with no nonlinearity == one matmul
        w1 = sd[f"{head}proj_in.weight"].T          # (F, 512)
        b1 = sd[f"{head}proj_in.bias"]
        w2 = conf_p["embed"]["weight"]               # (512, d)
        b2 = conf_p["embed"].get("bias", 0.0)
        conf_p["embed"] = {"weight": w1 @ w2, "bias": b1 @ w2 + b2}
    params["conformer"] = conf_p
    if conf_s:
        stats["conformer"] = conf_s
    params["unit_head"] = convert_mlp_head(sd, f"{head}proj_out")
    params["mel_head"] = convert_mel_head(sd, head)
    if f"{head}text_classifier.classifier.weight" in sd:
        params["text_head"] = _lin(sd, f"{head}text_classifier.classifier")
    return {"params": params, "batch_stats": stats}


def convert_vocoder_generator(sd: SD, cfg: VocoderConfig) -> dict:
    """g_######## generator state -> MelCodeGenerator params."""
    num_kernels = len(cfg.resblock_kernel_sizes)
    gen: dict = {"conv_pre": _wn_conv1d(sd, "conv_pre"),
                 "conv_post": _wn_conv1d(sd, "conv_post")}
    for i in range(len(cfg.upsample_rates)):
        gen[f"ups_{i}"] = _wn_convT1d(sd, f"ups.{i}")
        for j in range(num_kernels):
            m = i * num_kernels + j
            rb: dict = {}
            for c in range(3):
                rb[f"convs1_{c}"] = _wn_conv1d(sd, f"resblocks.{m}.convs1.{c}")
                rb[f"convs2_{c}"] = _wn_conv1d(sd, f"resblocks.{m}.convs2.{c}")
            gen[f"resblocks_{m}"] = rb
    return {
        "dict": {"embedding": sd["dict.weight"]},
        "code_upsample": _plain_convT1d_as_wn(sd, "layer.0"),
        "code_fc": _lin(sd, "fc"),
        "spkr": _lin(sd, "spkr"),
        "generator": gen,
    }


def convert_vocoder_discriminators(sd: SD) -> tuple[dict, dict, dict]:
    """do_######## -> (mpd_params, msd_params, msd_spectral)."""
    periods = (2, 3, 5, 7, 11)
    mpd: dict = {}
    for i, period in enumerate(periods):
        dp: dict = {}
        for j in range(5):
            dp[f"convs_{j}"] = _wn_conv2d(sd, f"mpd.discriminators.{i}.convs.{j}")
        dp["conv_post"] = _wn_conv2d(sd, f"mpd.discriminators.{i}.conv_post")
        mpd[f"disc_p{period}"] = dp

    msd: dict = {}
    spectral: dict = {}
    for i in range(3):
        ds: dict = {}
        sp: dict = {}
        for j in range(7):
            ds[f"convs_{j}"], u = _sn_or_wn_conv1d(sd, f"msd.discriminators.{i}.convs.{j}", i == 0)
            if u is not None:
                sp[f"convs_{j}"] = {"u": u}
        ds["conv_post"], u = _sn_or_wn_conv1d(sd, f"msd.discriminators.{i}.conv_post", i == 0)
        if u is not None:
            sp["conv_post"] = {"u": u}
        msd[f"disc_s{i}"] = ds
        if sp:
            spectral[f"disc_s{i}"] = sp
    return mpd, msd, spectral


def _sn_or_wn_conv1d(sd: SD, p: str, spectral: bool):
    if spectral:
        # torch spectral_norm stores weight_orig + weight_u (out-dim vector)
        w = sd[f"{p}.weight_orig"].transpose(2, 1, 0)
        return ({"weight": w, "bias": sd[f"{p}.bias"]}, sd[f"{p}.weight_u"])
    return (_wn_conv1d(sd, p), None)

# ---------------------------------------------------------------------------
# the port's state_dicts
# ---------------------------------------------------------------------------


def stage1_state_dict(sd: SD, cfg: MultiTargetConfig) -> dict[str, torch.Tensor]:
    """Stage-1 reference state_dict -> MultiTargetModel state_dict."""
    return from_jax.stage1_state_dict(convert_multi_target(sd, cfg))


def generator_state_dict(sd: SD, cfg: VocoderConfig) -> dict[str, torch.Tensor]:
    """g_######## state_dict -> MelCodeGenerator state_dict."""
    return from_jax.vocoder_state_dict(convert_vocoder_generator(sd, cfg))


def discriminator_state_dicts(sd: SD) -> dict[str, dict[str, torch.Tensor]]:
    """do_######## state_dict -> {"mpd", "msd"} state_dicts (the MSD's with
    its spectral-norm u buffers)."""
    mpd, msd, spectral = convert_vocoder_discriminators(sd)
    return {"mpd": from_jax.discriminator_state_dict(mpd),
            "msd": from_jax.discriminator_state_dict(msd, spectral)}


def load_stage1_weights(path: str | Path, cfg: MultiTargetConfig) -> dict[str, torch.Tensor]:
    """The model state_dict of a port s1_* file, or of a reference stage-1
    .pt converted; either is read weights-only (a fairseq file with a
    pickled config raises: convert it first)."""
    obj = _read(path)
    if checkpoint.is_port_checkpoint(obj):
        return obj["model"]
    return stage1_state_dict(unwrap(obj), cfg)


def load_generator_weights(path: str | Path, cfg: VocoderConfig) -> dict[str, torch.Tensor]:
    """The generator state_dict of a port g_* file, or of a reference g_*
    file converted; either is read weights-only."""
    obj = _read(path)
    if checkpoint.is_port_checkpoint(obj):
        return obj["generator"]
    return generator_state_dict(unwrap(obj), cfg)
