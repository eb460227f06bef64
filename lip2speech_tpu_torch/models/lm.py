"""Transformer language model and shallow fusion for beam decoding (JAX
reference: models/lm.py; the reference's espnet transformer LM and scorers
of the RAVEn eval harness): a causal transformer LM whose log-probs are
added to the acoustic model's (score = am + lm_weight * lm).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import LayerNorm, Linear
from lip2speech_tpu_torch.models.transformer_decoder import causal_attention, sinusoidal_positions
from lip2speech_tpu_torch.ops import nn as ops


class LMLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.heads = heads
        self.attn_norm = LayerNorm(dim, eps=1e-5)
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)
        self.ffn_norm = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, dim)

    def forward(self, x):
        y = self.attn_norm(x)
        att = causal_attention(self.q_proj(y), self.k_proj(y), self.v_proj(y), self.heads,
                               causal=True)
        x = x + self.out_proj(att)
        return x + self.fc2(ops.gelu(self.fc1(self.ffn_norm(x))))


class TransformerLM(nn.Module):
    """(B, L) tokens -> (B, L, V) next-token logits; the output projection is
    the embedding `embed` (V, D)."""

    def __init__(self, vocab_size: int, dim: int = 512, heads: int = 8, ffn_dim: int = 2048,
                 layers: int = 6, max_positions: int = 1024):
        super().__init__()
        self.dim = dim
        self.embed = nn.Parameter(torch.empty(vocab_size, dim))
        self.register_buffer("positions", torch.from_numpy(
            sinusoidal_positions(max_positions, dim)), persistent=False)
        for i in range(layers):
            self.add_module(f"layers_{i}", LMLayer(dim, heads, ffn_dim))
        self.n_layers = layers
        self.norm = LayerNorm(dim, eps=1e-5)

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.normal_(0.0, self.dim ** -0.5, generator=gen)

    def forward(self, tokens):
        x = self.embed[tokens] * math.sqrt(self.dim)
        x = x + self.positions[: tokens.shape[1]]
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.norm(x) @ self.embed.T


def fuse_with_lm(am_logits, lm: TransformerLM, lm_weight: float = 0.3):
    """Shallow fusion of a prefix scorer (tokens (N, L) -> (N, L, V) logits
    at every position) with the LM: log_softmax(am) + lm_weight *
    log_softmax(lm), position by position."""

    def fused(tokens):
        am = torch.log_softmax(am_logits(tokens), dim=-1)
        return am + lm_weight * torch.log_softmax(lm(tokens), dim=-1)

    return fused
