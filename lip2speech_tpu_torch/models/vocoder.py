"""Multi-input HiFi-GAN generator: units + mel + speaker -> 16 kHz waveform
(JAX reference: models/vocoder.py:35-364; discriminators come with the
training slice).

Activations are (B, C, T). Convs keep the weight-norm (weight_v, weight_g)
parametrisation, w = g * v / ||v||, with the norm over every dim but 0: the
output channel of a conv, the input channel of a transposed conv (torch
weight_norm's default dim=0 in both cases). Each stage with at most 128
channels runs its resblock trio through ops/fused_tail.py (the CUDA kernel
on the card); the wider first stage keeps the plain per-resblock loop.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.core.config import VocoderConfig
from lip2speech_tpu_torch.models.layers import Linear, uniform_
from lip2speech_tpu_torch.ops import nn as ops
from lip2speech_tpu_torch.ops.fused_tail import fused_resblock_trio, resblock1_plain

LRELU_SLOPE = 0.1
FUSED_MAX_CHANNELS = 128


class _WNConv(nn.Module):
    """weight_v (dim0, dim1, K), weight_g (dim0, 1, 1), bias (out,)."""

    def __init__(self, shape: tuple[int, int, int], out_ch: int, fan_in: int,
                 init_std: float | None):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.fan_in, self.init_std = fan_in, init_std

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.init_std is not None:           # HiFi-GAN init_weights
                self.weight_v.normal_(0.0, self.init_std, generator=gen)
            else:
                uniform_(self.weight_v, self.fan_in, gen)
            self.weight_g.copy_(self.weight_v.norm(dim=(1, 2), keepdim=True))
        uniform_(self.bias, self.fan_in, gen)

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * (self.weight_g / v.square().sum(dim=(1, 2), keepdim=True).sqrt())


class WNConv1d(_WNConv):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, padding: int = 0,
                 dilation: int = 1, init_std: float | None = 0.01):
        super().__init__((out_ch, in_ch, kernel), out_ch, in_ch * kernel, init_std)
        self.padding, self.dilation = padding, dilation

    def forward(self, x):
        return ops.conv1d(x, self.weight(), self.bias, 1, self.padding, self.dilation)


class WNConvTranspose1d(_WNConv):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int, init_std: float | None = 0.01):
        super().__init__((in_ch, out_ch, kernel), out_ch, in_ch * kernel, init_std)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return ops.conv_transpose1d(x, self.weight(), self.bias, self.stride, self.padding)


class ResBlock1(nn.Module):
    """3 dilation branches of [lrelu -> dilated conv -> lrelu -> conv] + residual."""

    def __init__(self, channels: int, kernel: int, dilations=(1, 3, 5)):
        super().__init__()
        self.kernel, self.dilations = kernel, tuple(dilations)
        for i, d in enumerate(self.dilations):
            pad1, pad2 = ops.branch_paddings(kernel, d)
            self.add_module(f"convs1_{i}", WNConv1d(channels, channels, kernel, pad1, d))
            self.add_module(f"convs2_{i}", WNConv1d(channels, channels, kernel, pad2, 1))

    def branch_weights(self):
        """[((w1, b1), (w2, b2)), ...] per dilation branch, weights composed."""
        convs = lambda i: (getattr(self, f"convs1_{i}"), getattr(self, f"convs2_{i}"))  # noqa: E731
        return [tuple((c.weight(), c.bias) for c in convs(i))
                for i in range(len(self.dilations))]

    def forward(self, x):
        return resblock1_plain(x, self.branch_weights(), self.kernel, self.dilations)


class HiFiGANGenerator(nn.Module):
    """conv_pre -> per stage [lrelu, ConvTranspose up, mean of resblocks] ->
    lrelu(0.01) -> conv_post -> tanh."""

    def __init__(self, h: VocoderConfig):
        super().__init__()
        self.h = h
        self.conv_pre = WNConv1d(h.model_in_dim, h.upsample_initial_channel, 7, 3)
        n_k = len(h.resblock_kernel_sizes)
        ch = h.upsample_initial_channel
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", WNConvTranspose1d(ch, ch // 2, k, u, (k - u) // 2))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * n_k + j}", ResBlock1(ch, rk, rd))
        self.conv_post = WNConv1d(ch, 1, 7, 3)

    def forward(self, x):
        """x (B, model_in_dim, T) conditioning at 100 Hz -> (B, T * prod(rates))."""
        h = self.h
        n_k = len(h.resblock_kernel_sizes)
        dils = [tuple(d) for d in h.resblock_dilation_sizes]
        x = self.conv_pre(x)
        for i in range(len(h.upsample_rates)):
            x = getattr(self, f"ups_{i}")(ops.leaky_relu(x, LRELU_SLOPE))
            rbs = [getattr(self, f"resblocks_{i * n_k + j}") for j in range(n_k)]
            if x.shape[1] <= FUSED_MAX_CHANNELS:
                x = fused_resblock_trio(x.contiguous(), [rb.branch_weights() for rb in rbs],
                                        h.resblock_kernel_sizes, dils)
            else:
                acc = None
                for rb in rbs:
                    y = rb(x)
                    acc = y if acc is None else acc + y
                x = acc / n_k
        x = self.conv_post(ops.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]


class MelCodeGenerator(nn.Module):
    """Unit embedding + 2x transposed conv, mel and projected speaker,
    concatenated into the generator's conditioning."""

    def __init__(self, h: VocoderConfig):
        super().__init__()
        self.dict = nn.Embedding(h.num_embeddings, h.embedding_dim)
        self.code_upsample = WNConvTranspose1d(h.embedding_dim, h.embedding_dim, 4, 2, 1,
                                               init_std=None)
        self.code_fc = Linear(h.embedding_dim, h.embedding_dim)
        self.spkr = Linear(h.embedder_dim, h.embedding_dim)
        self.generator = HiFiGANGenerator(h)

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.dict.weight.normal_(0.0, 1.0, generator=gen)

    def forward(self, code, mel, spk_emb):
        """code (B, Tc) int units in [0, 200); mel (B, 2Tc, 80); spk (B, 256)
        -> (B, 320 Tc) waveform in [-1, 1]."""
        y = self.code_upsample(self.dict(code).transpose(1, 2))   # (B, E, 2Tc)
        y = self.code_fc(ops.gelu(y).transpose(1, 2))            # (B, 2Tc, E)
        spk = self.spkr(spk_emb)[:, None, :].expand(-1, y.shape[1], -1)
        x = torch.cat([mel, y, spk], dim=-1).transpose(1, 2)
        return self.generator(x.contiguous())

