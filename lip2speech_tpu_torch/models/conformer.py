"""Macaron conformer encoder with Transformer-XL relative-position attention
(JAX reference: models/conformer.py), inference only: no dropout, no
layerscale, no drop-path. Activations are (B, T, D); masks (B, T), True =
valid. Attention goes through ops/rel_attention.py, which launches the CUDA
kernel on the card and runs the plain version on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import BatchNorm, Conv1d, LayerNorm, Linear
from lip2speech_tpu_torch.ops import nn as ops
from lip2speech_tpu_torch.ops.rel_attention import rel_attention


class RelPositionMultiHeadAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.linear_q = Linear(dim, dim)
        self.linear_k = Linear(dim, dim)
        self.linear_v = Linear(dim, dim)
        self.linear_pos = Linear(dim, dim, bias=False)
        self.linear_out = Linear(dim, dim)
        dk = dim // heads
        self.pos_bias_u = nn.Parameter(torch.empty(heads, dk))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, dk))

    def init_random(self, gen: torch.Generator) -> None:
        h, dk = self.pos_bias_u.shape
        bound = math.sqrt(6.0 / (h + dk))          # xavier_uniform on (H, dk)
        with torch.no_grad():
            self.pos_bias_u.uniform_(-bound, bound, generator=gen)
            self.pos_bias_v.uniform_(-bound, bound, generator=gen)

    def forward(self, x, pos_emb, mask):
        """x (B, T, D); pos_emb (2T-1, D); mask (B, T)."""
        b, t, d = x.shape
        h, dk = self.heads, d // self.heads
        q = self.linear_q(x).reshape(b, t, h, dk)
        heads_first = lambda y: y.transpose(1, 2).contiguous()  # noqa: E731
        q_u = heads_first(q + self.pos_bias_u)
        q_v = heads_first(q + self.pos_bias_v)
        k = heads_first(self.linear_k(x).reshape(b, t, h, dk))
        v = heads_first(self.linear_v(x).reshape(b, t, h, dk))
        p = heads_first(self.linear_pos(pos_emb).reshape(1, -1, h, dk))[0]
        out = rel_attention(q_u, q_v, k, v, p, mask)        # (B, H, T, dk)
        return self.linear_out(out.transpose(1, 2).reshape(b, t, d))


class FeedForward(nn.Module):
    """Linear -> ReLU -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w_1 = Linear(dim, hidden)
        self.w_2 = Linear(hidden, dim)

    def forward(self, x):
        return self.w_2(torch.relu(self.w_1(x)))


class ConvModule(nn.Module):
    """pointwise -> GLU -> depthwise(k) -> BN -> swish -> pointwise."""

    def __init__(self, dim: int, kernel: int = 31):
        super().__init__()
        self.pointwise_conv1 = Conv1d(dim, 2 * dim, 1)
        self.depthwise_conv = Conv1d(dim, dim, kernel, padding=(kernel - 1) // 2,
                                     groups=dim)
        self.norm = BatchNorm(dim)
        self.pointwise_conv2 = Conv1d(dim, dim, 1)

    def forward(self, x):
        x = ops.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        x = ops.swish(self.norm(self.depthwise_conv(x)))
        return self.pointwise_conv2(x).transpose(1, 2)


class ConformerLayer(nn.Module):
    """Macaron FFN x0.5 + rel-MHA + conv module + FFN x0.5, pre-norm, final LN."""

    def __init__(self, dim: int, ffn_dim: int, heads: int, conv_kernel: int = 31):
        super().__init__()
        self.norm_ff_macaron = LayerNorm(dim)
        self.feed_forward_macaron = FeedForward(dim, ffn_dim)
        self.norm_mha = LayerNorm(dim)
        self.self_attn = RelPositionMultiHeadAttention(dim, heads)
        self.norm_conv = LayerNorm(dim)
        self.conv_module = ConvModule(dim, conv_kernel)
        self.norm_ff = LayerNorm(dim)
        self.feed_forward = FeedForward(dim, ffn_dim)
        self.norm_final = LayerNorm(dim)

    def forward(self, x, pos_emb, mask):
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, mask)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """embed Linear, x sqrt(d), rel-pos table, N layers, after-norm."""

    def __init__(self, input_dim: int = 512, dim: int = 512, ffn_dim: int = 2048,
                 heads: int = 8, layers: int = 12, conv_kernel: int = 31):
        super().__init__()
        self.dim = dim
        self.embed = Linear(input_dim, dim)
        for i in range(layers):
            self.add_module(f"layers_{i}", ConformerLayer(dim, ffn_dim, heads, conv_kernel))
        self.n_layers = layers
        self.after_norm = LayerNorm(dim)

    def forward(self, x, mask):
        """x (B, T, F) frontend features; mask (B, T) -> (B, T, dim)."""
        x = self.embed(x)
        t = x.shape[1]
        pe = torch.tensor(ops.sinusoidal_rel_pos_encoding(t, self.dim),
                          dtype=x.dtype, device=x.device)
        x = x * float(math.sqrt(self.dim))
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, pe, mask)
        return self.after_norm(x)
