"""HuBERT-base audio model, the speech-unit teacher (JAX reference:
models/hubert.py). fairseq wav2vec2/HuBERT semantics:

  conv feature extractor: 7 bias-free layers (512,10,5) (512,3,2)x4 (512,2,2)x2,
    unpadded, GroupNorm(512, 512) on layer 0 only, GELU       => 50 Hz
  layer_norm on the features -> post_extract_proj (512 -> 768)
  conv positional embedding k128 g16, then layer norm (post-norm encoder)
  transformer: 12 post-norm layers, d 768, ffn 3072, 12 heads
  output_layer=6 returns the layer-6 activations, the unit-teacher features.

Reuses the wav2vec2 transformer stack of models/avhubert.py, so attention
runs the CUDA kernel of ops/attention.py on the card (no mask: all keys
valid). Inference only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_tpu_torch.models.avhubert import ConvPositionalEmbedding, TransformerLayer
from lip2speech_tpu_torch.models.layers import LayerNorm, Linear
from lip2speech_tpu_torch.ops import nn as ops

CONV_SPEC = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
             (512, 3, 2), (512, 2, 2), (512, 2, 2))


class GroupNorm512(nn.Module):
    """GroupNorm with one group per channel: each channel of (B, C, T) is
    normalised over time (biased variance, eps 1e-5)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.group_norm(x, x.shape[1], self.weight, self.bias, 1e-5)


class ConvFeatureExtractor(nn.Module):
    """(B, T_samples) -> (B, T_samples / 320, 512). The conv kernels are bare
    parameters conv{i}_weight, (out, in, k)."""

    def __init__(self):
        super().__init__()
        in_dim = 1
        for i, (dim, k, _) in enumerate(CONV_SPEC):
            setattr(self, f"conv{i}_weight", nn.Parameter(torch.empty(dim, in_dim, k)))
            in_dim = dim
        self.group_norm = GroupNorm512(CONV_SPEC[0][0])

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for i in range(len(CONV_SPEC)):
                w = getattr(self, f"conv{i}_weight")
                w.normal_(0.0, math.sqrt(2.0 / w[0].numel()), generator=gen)   # he_normal

    def forward(self, x):
        x = x[:, None, :]
        for i, (_, _, stride) in enumerate(CONV_SPEC):
            x = ops.conv1d(x, getattr(self, f"conv{i}_weight"), None, stride=stride)
            if i == 0:
                x = self.group_norm(x)
            x = ops.gelu(x)
        return x.transpose(1, 2)


class HubertBase(nn.Module):
    def __init__(self, dim: int = 768, heads: int = 12, ffn_dim: int = 3072, layers: int = 12):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor()
        self.layer_norm = LayerNorm(CONV_SPEC[-1][0], eps=1e-5)
        self.post_extract_proj = Linear(CONV_SPEC[-1][0], dim)
        self.pos_conv = ConvPositionalEmbedding(dim)
        self.encoder_layer_norm = LayerNorm(dim, eps=1e-5)
        for i in range(layers):
            self.add_module(f"layers_{i}", TransformerLayer(dim, heads, ffn_dim,
                                                            layer_norm_first=False))
        self.n_layers = layers

    def forward(self, wav, output_layer: int | None = None):
        """wav (B, T_samples) -> (B, T_samples / 320, dim): the activations
        after `output_layer` transformer layers (None: all of them)."""
        x = self.post_extract_proj(self.layer_norm(self.feature_extractor(wav)))
        x = self.encoder_layer_norm(x + self.pos_conv(x))
        n = self.n_layers if output_layer is None else min(output_layer, self.n_layers)
        for i in range(n):
            x = getattr(self, f"layers_{i}")(x, None)
        return x
