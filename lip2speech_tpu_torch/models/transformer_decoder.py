"""Transformer decoder for seq2seq ASR (JAX reference:
models/transformer_decoder.py; reference avhubert/decoder.py:38-253, the
fairseq TransformerDecoder of AVHubertSeq2Seq): scaled token embedding +
fairseq sinusoidal positions, pre-norm layers of (causal self-attention,
cross-attention to the encoder, FFN), the output projection shared with the
embedding unless share_embed is off.

The beam search re-scores the prefix each step (no KV cache); masks fill
with -1e9, not -inf, so a fully masked row averages its values as in the
JAX module. Attention here is plain matmuls and softmax: the rows are a few
dozen tokens, and a boolean-mask SDPA would fill with -inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import LayerNorm, Linear
from lip2speech_tpu_torch.ops import nn as ops

MASKED = -1e9


def sinusoidal_positions(length: int, dim: int, padding_idx: int = 1) -> np.ndarray:
    """fairseq SinusoidalPositionalEmbedding table (offset by padding_idx+1)."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    emb = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(padding_idx + 1, padding_idx + 1 + length, dtype=np.float64)
    ang = pos[:, None] * emb[None, :]
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        out = np.concatenate([out, np.zeros((length, 1))], axis=1)
    return out.astype(np.float32)


def causal_attention(q, k, v, heads: int, kv_mask=None, causal: bool = False):
    """q (B, Tq, D), k and v (B, Tk, D) -> (B, Tq, D): softmax attention with
    masked scores set to -1e9."""
    b, t, d = q.shape
    dk = d // heads
    q = q.reshape(b, t, heads, dk)
    k = k.reshape(b, k.shape[1], heads, dk)
    v = v.reshape(b, v.shape[1], heads, dk)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], MASKED)
    if causal:
        tri = torch.ones(t, k.shape[1], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~tri, MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, d)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x, kv, kv_mask=None, causal: bool = False):
        out = causal_attention(self.q_proj(x), self.k_proj(kv), self.v_proj(kv), self.heads,
                               kv_mask, causal)
        return self.out_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn_layer_norm = LayerNorm(dim, eps=1e-5)
        self.self_attn = CrossAttention(dim, heads)
        self.encoder_attn_layer_norm = LayerNorm(dim, eps=1e-5)
        self.encoder_attn = CrossAttention(dim, heads)
        self.final_layer_norm = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, dim)

    def forward(self, x, enc, enc_mask):
        y = self.self_attn_layer_norm(x)
        x = x + self.self_attn(y, y, causal=True)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), enc, enc_mask)
        return x + self.fc2(ops.gelu(self.fc1(self.final_layer_norm(x))))


class TransformerDecoder(nn.Module):
    """tokens (B, L) prefix, enc (B, Te, D), enc_mask (B, Te) -> (B, L, V)
    logits. embed_tokens (V, D) and output_proj (D, V) are bare parameters
    under the JAX names."""

    def __init__(self, vocab_size: int, dim: int = 768, heads: int = 4, ffn_dim: int = 3072,
                 layers: int = 6, max_positions: int = 2048, share_embed: bool = True,
                 padding_idx: int = 1):
        super().__init__()
        self.dim = dim
        self.embed_tokens = nn.Parameter(torch.empty(vocab_size, dim))
        self.output_proj = None if share_embed else nn.Parameter(torch.empty(dim, vocab_size))
        self.register_buffer("positions", torch.from_numpy(
            sinusoidal_positions(max_positions, dim, padding_idx)), persistent=False)
        for i in range(layers):
            self.add_module(f"layers_{i}", DecoderLayer(dim, heads, ffn_dim))
        self.n_layers = layers
        self.layer_norm = LayerNorm(dim, eps=1e-5)

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.embed_tokens, self.output_proj):
                if p is not None:
                    p.normal_(0.0, self.dim ** -0.5, generator=gen)

    def forward(self, tokens, enc, enc_mask):
        x = self.embed_tokens[tokens] * math.sqrt(self.dim)
        x = x + self.positions[: tokens.shape[1]]
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, enc, enc_mask)
        x = self.layer_norm(x)
        return x @ (self.embed_tokens.T if self.output_proj is None else self.output_proj)
