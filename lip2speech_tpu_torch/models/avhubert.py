"""AV-HuBERT audio-visual encoder, the frozen frontend of the flagship preset
(JAX reference: models/avhubert.py).

  video: prelu ResNet3D -> video_proj Linear(512 -> D)
  audio: audio_proj Linear(F -> D)   (F = 104 stacked log-filterbank features)
  an absent modality contributes zeros
  -> concat([audio, video]) -> LayerNorm(2D) -> post_extract_proj(2D -> D)
  -> wav2vec2 transformer (conv positional embedding k128 g16, pre- or
     post-norm layers, plain softmax attention)

Activations are (B, T, D); masks (B, T), True = valid. Attention goes through
ops/attention.py, which launches the CUDA kernel on the card and runs the
plain version on the CPU. LayerNorm eps is fairseq's 1e-5.

In training mode (`module.train()`, not the frozen-frontend use, which runs
in eval mode) dropout is on after the input projection, on the trunk's input
and on both residual branches of every layer, and modality dropout zeroes
one whole modality with one draw per forward when both are given. With
attention dropout active the probabilities are dropped on the dense path, as
in the JAX module: the attention kernel has no dropout. The noise draws from
the `torch.Generator` given to `forward` (None: the default generator).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import Conv1d, LayerNorm, Linear
from lip2speech_tpu_torch.models.resnet3d import ResNet3DFrontend
from lip2speech_tpu_torch.ops import nn as ops
from lip2speech_tpu_torch.ops.attention import attention
from lip2speech_tpu_torch.parallel.collectives import copy_to_model, row_parallel


class SelfAttention(nn.Module):
    """fairseq MultiheadAttention as self-attention, batch first. Head-parallel
    under tensor parallelism (`tp` set, parallel/sharding_rules.py): the rank
    holds its heads of q/k/v_proj and its columns of out_proj."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)
        self.tp = None

    def tp_parts(self) -> int:
        return self.heads

    def forward(self, x, mask=None, gen=None):
        """x (B, T, D); mask (B, T) key mask or None (all keys valid)."""
        b, t, d = x.shape
        tp = self.tp
        h, dk = self.heads, d // self.heads
        shard = None
        if tp is not None:
            h, x, shard = h // tp.size, copy_to_model(x, tp), (1, tp.index, tp.size)
        heads_first = lambda y: y.reshape(b, t, h, dk).transpose(1, 2).contiguous()  # noqa: E731
        q, k, v = (heads_first(proj(x)) for proj in (self.q_proj, self.k_proj, self.v_proj))
        if self.training and self.dropout > 0.0:
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dk)
            if mask is not None:
                s = s.masked_fill(~mask[:, None, None, :], -1e9)
            attn = ops.dropout(torch.softmax(s, dim=-1), self.dropout, gen, shard=shard)
            out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        else:
            out = attention(q, k, v, mask)                          # (B, H, T, dk)
        out = out.transpose(1, 2).reshape(b, t, h * dk)
        return self.out_proj(out) if tp is None else row_parallel(out, self.out_proj, tp)


class TransformerLayer(nn.Module):
    """fairseq TransformerSentenceEncoderLayer (GELU, pre- or post-norm).
    Under tensor parallelism (`tp` set) the rank holds its hidden units of
    the FFN: rows of fc1, columns of fc2."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, layer_norm_first: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.dropout = dropout
        self.self_attn = SelfAttention(dim, heads, dropout)
        self.self_attn_layer_norm = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, dim)
        self.final_layer_norm = LayerNorm(dim, eps=1e-5)
        self.tp = None

    def tp_parts(self) -> int:
        return self.fc1.weight.shape[0]

    def _ffn(self, x):
        if self.tp is None:
            return self.fc2(ops.gelu(self.fc1(x)))
        return row_parallel(ops.gelu(self.fc1(copy_to_model(x, self.tp))), self.fc2, self.tp)

    def forward(self, x, mask=None, gen=None):
        drop = (lambda y: ops.dropout(y, self.dropout, gen)) if self.training else (lambda y: y)
        if self.layer_norm_first:
            x = x + drop(self.self_attn(self.self_attn_layer_norm(x), mask, gen))
            return x + drop(self._ffn(self.final_layer_norm(x)))
        x = self.self_attn_layer_norm(x + drop(self.self_attn(x, mask, gen)))
        return self.final_layer_norm(x + drop(self._ffn(x)))


class ConvPositionalEmbedding(nn.Module):
    """wav2vec2 positional embedding: grouped Conv1d(k, padding k/2), the
    trailing step dropped for an even kernel, GELU. (B, T, D) -> (B, T, D)."""

    def __init__(self, dim: int, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.kernel = kernel
        self.conv = Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x):
        y = self.conv(x.transpose(1, 2))
        if self.kernel % 2 == 0:
            y = y[:, :, :-1]
        return ops.gelu(y).transpose(1, 2)


class Wav2Vec2TransformerEncoder(nn.Module):
    """fairseq wav2vec2 TransformerEncoder (the AV-HuBERT trunk)."""

    def __init__(self, dim: int = 1024, heads: int = 16, ffn_dim: int = 4096,
                 layers: int = 24, layer_norm_first: bool = True, dropout: float = 0.1):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.dropout = dropout
        self.pos_conv = ConvPositionalEmbedding(dim)
        for i in range(layers):
            self.add_module(f"layers_{i}",
                            TransformerLayer(dim, heads, ffn_dim, layer_norm_first, dropout))
        self.n_layers = layers
        self.layer_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask=None, gen=None):
        if mask is not None:      # padded positions are zeroed before the positional conv
            x = torch.where(mask[:, :, None], x, 0.0)
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        if self.training:
            x = ops.dropout(x, self.dropout, gen)
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, mask, gen)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return x


def fuse_modality_features(feats_a, feats_v, modality_dropout: float, audio_dropout: float,
                           train: bool, gen=None):
    """An absent modality contributes zeros; with both present in training,
    ONE pair of uniform draws per forward decides whether a whole modality is
    zeroed: with probability modality_dropout, audio with probability
    audio_dropout, else video. Returns (feats_a, feats_v)."""
    both = feats_a is not None and feats_v is not None
    if feats_v is None:
        feats_v = torch.zeros_like(feats_a)
    if feats_a is None:
        feats_a = torch.zeros_like(feats_v)
    if train and modality_dropout > 0.0 and both:
        r_mod, r_aud = torch.rand(2, device=feats_a.device, generator=gen)
        drop_audio = (r_mod < modality_dropout) & (r_aud < audio_dropout)
        drop_video = (r_mod < modality_dropout) & ~(r_aud < audio_dropout)
        feats_a = torch.where(drop_audio, 0.0, feats_a)
        feats_v = torch.where(drop_video, 0.0, feats_v)
    return feats_a, feats_v


class AVHubertEncoder(nn.Module):
    """video (B, T, H, W, 1) or None; audio (B, T, F) or None -> (B, T, dim).
    audio_feat_dim == 0 (the serving default) builds a video-only module with
    no audio parameters."""

    def __init__(self, dim: int = 1024, heads: int = 16, ffn_dim: int = 4096,
                 layers: int = 24, layer_norm_first: bool = True, audio_feat_dim: int = 0,
                 dropout: float = 0.1, modality_dropout: float = 0.0,
                 audio_dropout: float = 0.0):
        super().__init__()
        self.audio_feat_dim = audio_feat_dim
        self.dropout = dropout
        self.modality_dropout, self.audio_dropout = modality_dropout, audio_dropout
        self.resnet = ResNet3DFrontend(relu_type="prelu")
        self.video_proj = Linear(512, dim)
        if audio_feat_dim > 0:
            self.audio_proj = Linear(audio_feat_dim, dim)
        self.fuse_layer_norm = LayerNorm(2 * dim, eps=1e-5)
        self.post_extract_proj = Linear(2 * dim, dim)
        self.encoder = Wav2Vec2TransformerEncoder(dim, heads, ffn_dim, layers, layer_norm_first,
                                                  dropout)

    def forward(self, video=None, frames_mask=None, audio=None, gen=None):
        if video is None and audio is None:
            raise ValueError("need at least one modality")
        if audio is not None and self.audio_feat_dim == 0:
            raise ValueError("audio passed to a video-only encoder (set audio_feat_dim)")
        feats_v = None if video is None else self.video_proj(self.resnet(video))
        feats_a = None if audio is None else self.audio_proj(audio)
        feats_a, feats_v = fuse_modality_features(feats_a, feats_v, self.modality_dropout,
                                                  self.audio_dropout, self.training, gen)
        fused = self.fuse_layer_norm(torch.cat([feats_a, feats_v], dim=-1))
        x = self.post_extract_proj(fused)
        if self.training:
            x = ops.dropout(x, self.dropout, gen)
        return self.encoder(x, frames_mask, gen)
