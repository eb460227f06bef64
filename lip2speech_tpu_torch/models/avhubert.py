"""AV-HuBERT audio-visual encoder, the frozen frontend of the flagship preset
(JAX reference: models/avhubert.py), inference only: no dropout, no modality
dropout.

  video: prelu ResNet3D -> video_proj Linear(512 -> D)
  audio: audio_proj Linear(F -> D)   (F = 104 stacked log-filterbank features)
  an absent modality contributes zeros
  -> concat([audio, video]) -> LayerNorm(2D) -> post_extract_proj(2D -> D)
  -> wav2vec2 transformer (conv positional embedding k128 g16, pre- or
     post-norm layers, plain softmax attention)

Activations are (B, T, D); masks (B, T), True = valid. Attention goes through
ops/attention.py, which launches the CUDA kernel on the card and runs the
plain version on the CPU. LayerNorm eps is fairseq's 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import Conv1d, LayerNorm, Linear
from lip2speech_tpu_torch.models.resnet3d import ResNet3DFrontend
from lip2speech_tpu_torch.ops import nn as ops
from lip2speech_tpu_torch.ops.attention import attention


class SelfAttention(nn.Module):
    """fairseq MultiheadAttention as self-attention, batch first."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x, mask=None):
        """x (B, T, D); mask (B, T) key mask or None (all keys valid)."""
        b, t, d = x.shape
        h = self.heads
        heads_first = lambda y: y.reshape(b, t, h, d // h).transpose(1, 2).contiguous()  # noqa: E731
        out = attention(heads_first(self.q_proj(x)), heads_first(self.k_proj(x)),
                        heads_first(self.v_proj(x)), mask)          # (B, H, T, dk)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class TransformerLayer(nn.Module):
    """fairseq TransformerSentenceEncoderLayer (GELU, pre- or post-norm)."""

    def __init__(self, dim: int, heads: int, ffn_dim: int, layer_norm_first: bool = True):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.self_attn = SelfAttention(dim, heads)
        self.self_attn_layer_norm = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, dim)
        self.final_layer_norm = LayerNorm(dim, eps=1e-5)

    def _ffn(self, x):
        return self.fc2(ops.gelu(self.fc1(x)))

    def forward(self, x, mask=None):
        if self.layer_norm_first:
            x = x + self.self_attn(self.self_attn_layer_norm(x), mask)
            return x + self._ffn(self.final_layer_norm(x))
        x = self.self_attn_layer_norm(x + self.self_attn(x, mask))
        return self.final_layer_norm(x + self._ffn(x))


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
                 layers: int = 24, layer_norm_first: bool = True):
        super().__init__()
        self.layer_norm_first = layer_norm_first
        self.pos_conv = ConvPositionalEmbedding(dim)
        for i in range(layers):
            self.add_module(f"layers_{i}", TransformerLayer(dim, heads, ffn_dim, layer_norm_first))
        self.n_layers = layers
        self.layer_norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask=None):
        if mask is not None:      # padded positions are zeroed before the positional conv
            x = torch.where(mask[:, :, None], x, 0.0)
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, mask)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return x


class AVHubertEncoder(nn.Module):
    """video (B, T, H, W, 1) or None; audio (B, T, F) or None -> (B, T, dim).
    audio_feat_dim == 0 (the serving default) builds a video-only module with
    no audio parameters."""

    def __init__(self, dim: int = 1024, heads: int = 16, ffn_dim: int = 4096,
                 layers: int = 24, layer_norm_first: bool = True, audio_feat_dim: int = 0):
        super().__init__()
        self.audio_feat_dim = audio_feat_dim
        self.resnet = ResNet3DFrontend(relu_type="prelu")
        self.video_proj = Linear(512, dim)
        if audio_feat_dim > 0:
            self.audio_proj = Linear(audio_feat_dim, dim)
        self.fuse_layer_norm = LayerNorm(2 * dim, eps=1e-5)
        self.post_extract_proj = Linear(2 * dim, dim)
        self.encoder = Wav2Vec2TransformerEncoder(dim, heads, ffn_dim, layers, layer_norm_first)

    def forward(self, video=None, frames_mask=None, audio=None):
        if video is None and audio is None:
            raise ValueError("need at least one modality")
        if audio is not None and self.audio_feat_dim == 0:
            raise ValueError("audio passed to a video-only encoder (set audio_feat_dim)")
        feats_v = None if video is None else self.video_proj(self.resnet(video))
        feats_a = None if audio is None else self.audio_proj(audio)
        if feats_v is None:
            feats_v = torch.zeros_like(feats_a)
        if feats_a is None:
            feats_a = torch.zeros_like(feats_v)
        fused = self.fuse_layer_norm(torch.cat([feats_a, feats_v], dim=-1))
        return self.encoder(self.post_extract_proj(fused), frames_mask)
