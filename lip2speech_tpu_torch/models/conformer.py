"""Conformer encoder with Transformer-XL relative-position attention (JAX
reference: models/conformer.py). The flags cover the stage-1 trunk and the
Auto-AVSR frontend (macaron, conv module) and the RAVEn transformer (neither,
with layerscale and BatchNorm FFN pre-norms). Activations are (B, T, D);
masks (B, T), True = valid. Attention goes through ops/rel_attention.py,
which launches the CUDA kernels (forward and backward) on the card and runs
the plain version on the CPU.

In training mode (`module.train()`) the recipe's noise is on: dropout on the
attention probabilities (inside the kernel on the card), after the FFN
activation, on every residual branch, on the scaled input and on the
position table; drop-path per sample with a rate rising linearly over the
layers; BatchNorm uses batch statistics. All of it draws from the
`torch.Generator` given to `forward` (None: the default generator), so a
seed fixes the masks. The attention-dropout mask of each layer is selected by
a host integer handed to the kernel by value; those come from a generator on
the CPU (`seed_gen`), so drawing them never waits for the card. In eval mode
none of it runs.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import BatchNorm, Conv1d, LayerNorm, Linear
from lip2speech_tpu_torch.ops import nn as ops
from lip2speech_tpu_torch.ops.rel_attention import rel_attention
from lip2speech_tpu_torch.parallel.collectives import copy_to_model, row_parallel


class RelPositionMultiHeadAttention(nn.Module):
    """Head-parallel under tensor parallelism (parallel/sharding_rules.py:
    `tp` set): the rank holds its heads of linear_q/k/v (weights and biases)
    and pos_bias_u/v, and its columns of linear_out; linear_pos is whole, and
    the rank takes its heads of its output. The kernel runs on the rank's
    heads, with the layer's dropout seed offset by the rank's model index."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.tp = None
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

    def tp_parts(self) -> int:
        return self.heads

    def forward(self, x, pos_emb, mask, seed: int = 0):
        """x (B, T, D); pos_emb (2T-1, D); mask (B, T); seed selects the
        attention-dropout mask in training mode."""
        b, t, d = x.shape
        tp = self.tp
        h, dk = self.heads, d // self.heads
        p = self.linear_pos(pos_emb)
        if tp is not None:
            h, x = h // tp.size, copy_to_model(x, tp)
            p = copy_to_model(p, tp).chunk(tp.size, -1)[tp.index]
            seed = (seed + tp.index) % (2 ** 31 - 1)
        q = self.linear_q(x).reshape(b, t, h, dk)
        heads_first = lambda y: y.transpose(1, 2).contiguous()  # noqa: E731
        q_u = heads_first(q + self.pos_bias_u)
        q_v = heads_first(q + self.pos_bias_v)
        k = heads_first(self.linear_k(x).reshape(b, t, h, dk))
        v = heads_first(self.linear_v(x).reshape(b, t, h, dk))
        p = heads_first(p.reshape(1, -1, h, dk))[0]
        rate = self.dropout if self.training else 0.0
        out = rel_attention(q_u, q_v, k, v, p, mask, dropout_rate=rate, seed=seed)  # (B, H, T, dk)
        out = out.transpose(1, 2).reshape(b, t, h * dk)
        if tp is None:
            return self.linear_out(out)
        return row_parallel(out, self.linear_out, tp)


class FeedForward(nn.Module):
    """Linear -> ReLU -> dropout (training) -> Linear. Under tensor
    parallelism the rank holds its hidden units: rows of w_1, columns of
    w_2."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.w_1 = Linear(dim, hidden)
        self.w_2 = Linear(hidden, dim)
        self.tp = None

    def tp_parts(self) -> int:
        return self.w_1.weight.shape[0]

    def forward(self, x, gen=None):
        tp = self.tp
        if tp is None:
            x = torch.relu(self.w_1(x))
            if self.training:
                x = ops.dropout(x, self.dropout, gen)
            return self.w_2(x)
        x = torch.relu(self.w_1(copy_to_model(x, tp)))
        if self.training:
            x = ops.dropout(x, self.dropout, gen, shard=(-1, tp.index, tp.size))
        return row_parallel(x, self.w_2, tp)


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
    """[macaron FFN x0.5] + rel-MHA + [conv module] + FFN (x0.5 with macaron),
    each a residual branch normed before (normalize_before) or after; a final
    LN when the conv module is on. layerscale multiplies each branch by a
    learned per-channel gamma; ff_bn_pre makes the FFN and conv norms
    BatchNorm instead of LayerNorm (RAVEn). In training mode each branch is
    x + drop_path(scale * gamma * dropout(branch))."""

    def __init__(self, dim: int, ffn_dim: int, heads: int, conv_kernel: int = 31,
                 macaron: bool = True, use_conv: bool = True, normalize_before: bool = True,
                 layerscale: bool = False, init_values: float = 0.1, ff_bn_pre: bool = False,
                 dropout: float = 0.1, attention_dropout: float = 0.1, drop_path: float = 0.0):
        super().__init__()
        self.dropout, self.drop_path = dropout, drop_path
        self.normalize_before = normalize_before
        self.ff_scale = 0.5 if macaron else 1.0
        self.init_values = init_values
        ff_norm = BatchNorm if ff_bn_pre else LayerNorm
        branches = [("ff_macaron", macaron), ("mha", True), ("conv", use_conv), ("ff", True)]
        self.branches = [name for name, on in branches if on]
        if macaron:
            self.norm_ff_macaron = ff_norm(dim)
            self.feed_forward_macaron = FeedForward(dim, ffn_dim, dropout)
        self.norm_mha = LayerNorm(dim)
        self.self_attn = RelPositionMultiHeadAttention(dim, heads, attention_dropout)
        if use_conv:
            self.norm_conv = ff_norm(dim)
            self.conv_module = ConvModule(dim, conv_kernel)
            self.norm_final = LayerNorm(dim)
        self.norm_ff = ff_norm(dim)
        self.feed_forward = FeedForward(dim, ffn_dim, dropout)
        if layerscale:
            for name in self.branches:
                setattr(self, f"gamma_{name}", nn.Parameter(torch.empty(dim)))
        self.layerscale = layerscale

    def init_random(self, gen: torch.Generator) -> None:
        if self.layerscale:
            with torch.no_grad():
                for name in self.branches:
                    getattr(self, f"gamma_{name}").fill_(self.init_values)

    def _norm(self, name: str, x):
        norm = getattr(self, f"norm_{name}")
        if isinstance(norm, BatchNorm):                     # over channels, (B, T, D) input
            return norm(x.transpose(1, 2)).transpose(1, 2)
        return norm(x)

    def _branch(self, name: str, fn, scale: float, x, gen):
        y = fn(self._norm(name, x) if self.normalize_before else x)
        if self.training:
            y = ops.dropout(y, self.dropout, gen)
        if self.layerscale:
            y = getattr(self, f"gamma_{name}") * y
        if scale != 1.0:
            y = scale * y
        if self.training:
            y = ops.drop_path(y, self.drop_path, gen)
        x = x + y
        return x if self.normalize_before else self._norm(name, x)

    def forward(self, x, pos_emb, mask, gen=None, seed: int = 0):
        """gen: generator of the dropout and drop-path masks; seed: of the
        attention-dropout mask (both read in training mode only)."""
        if "ff_macaron" in self.branches:
            x = self._branch("ff_macaron", lambda y: self.feed_forward_macaron(y, gen), 0.5, x, gen)
        x = self._branch("mha", lambda y: self.self_attn(y, pos_emb, mask, seed), 1.0, x, gen)
        if "conv" in self.branches:
            x = self._branch("conv", self.conv_module, 1.0, x, gen)
        x = self._branch("ff", lambda y: self.feed_forward(y, gen), self.ff_scale, x, gen)
        return self.norm_final(x) if "conv" in self.branches else x


class ConformerEncoder(nn.Module):
    """embed Linear, x sqrt(d), rel-pos table, N layers, after-norm (with
    normalize_before)."""

    def __init__(self, input_dim: int = 512, dim: int = 512, ffn_dim: int = 2048,
                 heads: int = 8, layers: int = 12, conv_kernel: int = 31,
                 macaron: bool = True, use_conv: bool = True, normalize_before: bool = True,
                 layerscale: bool = False, init_values: float = 0.1, ff_bn_pre: bool = False,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 positional_dropout: float = 0.1, drop_path: float = 0.0):
        super().__init__()
        self.dim = dim
        self.positional_dropout = positional_dropout
        self.embed = Linear(input_dim, dim)
        for i in range(layers):
            self.add_module(f"layers_{i}", ConformerLayer(
                dim, ffn_dim, heads, conv_kernel, macaron, use_conv, normalize_before,
                layerscale, init_values, ff_bn_pre, dropout, attention_dropout,
                drop_path * i / max(layers - 1, 1)))
        self.n_layers = layers
        self.after_norm = LayerNorm(dim) if normalize_before else None
        self._pos_tables: dict = {}        # (T, dtype, device) -> (2T-1, dim) table

    def _pos_table(self, t: int, dtype, device) -> torch.Tensor:
        key = (t, dtype, device)
        pe = self._pos_tables.get(key)
        if pe is None:
            if len(self._pos_tables) >= 16:                 # a few buckets in practice
                self._pos_tables.clear()
            with torch.inference_mode(False):               # usable in any later mode
                pe = torch.tensor(ops.sinusoidal_rel_pos_encoding(t, self.dim),
                                  dtype=dtype, device=device)
            self._pos_tables[key] = pe
        return pe

    def forward(self, x, mask, gen=None, seed_gen=None):
        """x (B, T, F) frontend features; mask (B, T) -> (B, T, dim). gen:
        the generator of the training-mode noise on x's device (None: the
        default one). seed_gen: a CPU generator of the per-layer
        attention-dropout seeds (None: gen when it lives on the CPU, else
        the CPU's default generator)."""
        x = self.embed(x)
        pe = self._pos_table(x.shape[1], x.dtype, x.device)
        x = x * float(math.sqrt(self.dim))
        seeds = [0] * self.n_layers
        if self.training:
            x = ops.dropout(x, self.positional_dropout, gen)
            pe = ops.dropout(pe, self.positional_dropout, gen)
            # one attention-dropout seed per layer, drawn on the host
            if seed_gen is None and gen is not None and gen.device.type == "cpu":
                seed_gen = gen
            seeds = torch.randint(0, 2 ** 31 - 1, (self.n_layers,), generator=seed_gen).tolist()
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, pe, mask, gen, seeds[i])
        return x if self.after_norm is None else self.after_norm(x)
