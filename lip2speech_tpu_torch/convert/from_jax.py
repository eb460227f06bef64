"""JAX parameter trees -> the port's state_dicts (the inverse direction of
the JAX package's convert/torch_to_jax.py).

The port's modules carry the JAX package's names (layers_0, resblocks_3,
convs1_2, ...), so a leaf's key is its tree path joined by dots. Only the
layouts move:

  Linear      (in, out)                    -> (out, in)
  Conv1d      (K, I, O)                    -> (O, I, K)
  ConvT1d     (K, O, I)                    -> (I, O, K)
  Conv2d      (kh, kw, I, O)               -> (O, I, kh, kw)
  Conv3d      (kt, kh, kw, I, O)           -> (O, I, kt, kh, kw)
  WN conv     weight_v (K, I, O), g (O,)   -> (O, I, K), g (O, 1, 1)
  WN convT    weight_v (K, O, I), g (I,)   -> (I, O, K), g (I, 1, 1)
  WN conv2d   weight_v (kh, kw, I, O), g (O,) -> (O, I, kh, kw), g (O, 1, 1, 1)
  spectral    weight (K, I, O)             -> (O, I, K); the "spectral"
              collection's u (O,) -> the conv's u buffer
  nn.Embed    embedding                    -> nn.Embedding weight
  HuBERT feature-extractor convs, bare parameters conv{i}_weight
              (K, I, O)                    -> (O, I, K)

Vectors carry over as they are: biases, norm scales, BatchNorm running
statistics, pos_bias_u/v, PReLU alphas, layerscale gammas, GroupNorm
weight and bias; so do the pretraining model's mask_emb and label_embs and
the VQ's "vq_stats" collection (codebook, ema_count, ema_sum), which become
buffers.
Inputs are nested dicts of numpy arrays. A gradient tree has the layout of
its parameter tree, so `jax_tree_to_state_dict` names and lays out
gradients too.
"""

from __future__ import annotations

import re
from typing import Any, Iterator

import numpy as np
import torch

_WEIGHT_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _leaves(tree: dict[str, Any], prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert_leaf(path: tuple[str, ...], x: np.ndarray) -> tuple[str, torch.Tensor]:
    name = path[-1]
    if name == "embedding":
        return ".".join(path[:-1] + ("weight",)), torch.tensor(x)
    if name == "weight" and x.ndim >= 2:
        x = x.transpose(_WEIGHT_PERM[x.ndim])
    elif name == "weight_v":
        x = x.transpose(_WEIGHT_PERM[x.ndim])
    elif re.fullmatch(r"conv\d+_weight", name):
        x = x.transpose(2, 1, 0)
    return ".".join(path), torch.tensor(np.ascontiguousarray(x))


def jax_tree_to_state_dict(tree: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Flat port state_dict from one JAX tree (a params, batch_stats or
    spectral tree). A weight_g takes the rank of its weight_v."""
    sd = dict(_convert_leaf(path, x) for path, x in _leaves(tree))
    for key, g in sd.items():
        if key.endswith("weight_g"):
            sd[key] = g.reshape((-1,) + (1,) * (sd[key[:-1] + "v"].ndim - 1))
    return sd


def stage1_state_dict(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of MultiTargetModel -> state_dict."""
    sd = jax_tree_to_state_dict(variables["params"])
    sd.update(jax_tree_to_state_dict(variables.get("batch_stats", {})))
    return sd


def _collections(variables: dict[str, Any], required: tuple[str, ...],
                 optional: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """One state_dict from several flax collections; a collection missing
    from `required`, or one named in neither tuple, raises KeyError."""
    unknown = sorted(set(variables) - set(required) - set(optional))
    missing = sorted(set(required) - set(variables))
    if unknown or missing:
        raise KeyError(f"collections: unknown {unknown}, missing {missing}")
    sd = {}
    for name in required + optional:
        sd.update(jax_tree_to_state_dict(variables.get(name, {})))
    return sd


def pretrain_state_dict(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of AVHubertPretrainModel -> state_dict;
    mask_emb (F,) and label_embs (classes, final_dim) carry over as they
    are."""
    return _collections(variables, ("params", "batch_stats"))


def vq_state_dict(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """{"vq_stats"[, "params"]} of VQBottleneck or VQQuantizer -> state_dict:
    the EMA state (codebook, ema_count, ema_sum) becomes the buffers of the
    same names."""
    return _collections(variables, ("vq_stats",), ("params",))


def vocoder_state_dict(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """MelCodeGenerator params -> state_dict."""
    return jax_tree_to_state_dict(params)


def hubert_state_dict(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """HubertBase params -> state_dict."""
    return jax_tree_to_state_dict(params)


def discriminator_state_dict(params: dict[str, Any],
                             spectral: dict[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """MultiPeriodDiscriminator params, or MultiScaleDiscriminator params
    with its "spectral" collection (the u vectors) -> state_dict."""
    sd = jax_tree_to_state_dict(params)
    sd.update(jax_tree_to_state_dict(spectral or {}))
    return sd


def speaker_state_dict(params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """GE2E encoder params ({"lstm_{k}": {w_ih, w_hh, b_ih, b_hh}, "linear":
    {weight (in, out), bias}}) -> SpeakerEncoder's state_dict (nn.LSTM's
    names; the linear weight transposed to (out, in))."""
    sd = {}
    for key, layer in params.items():
        if key == "linear":
            continue
        k = int(key.rsplit("_", 1)[1])
        for ours, theirs in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                             ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
            sd[f"lstm.{ours}_l{k}"] = torch.tensor(np.asarray(layer[theirs]))
    sd["linear.weight"] = torch.tensor(np.ascontiguousarray(np.asarray(params["linear"]["weight"]).T))
    sd["linear.bias"] = torch.tensor(np.asarray(params["linear"]["bias"]))
    return sd


def asr_state_dict(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """{"encoder": {"params", "batch_stats"}, "decoder": {"params"}} of
    AVHubertSeq2Seq or RavenASR -> the port model's state_dict (encoder.*,
    decoder.*; the decoder's bare embed_tokens / output_proj unchanged)."""
    sd = {}
    for part in ("encoder", "decoder"):
        tree = variables[part]
        sd.update({f"{part}.{k}": v for k, v in stage1_state_dict(
            {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}).items()})
    return sd


def lm_state_dict(variables: dict[str, Any]) -> dict[str, torch.Tensor]:
    """{"params": ...} of TransformerLM -> state_dict (the bare embed
    unchanged)."""
    return jax_tree_to_state_dict(variables["params"])
