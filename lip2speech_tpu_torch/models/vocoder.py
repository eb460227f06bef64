"""Multi-input HiFi-GAN: the generator (units + mel + speaker -> 16 kHz
waveform), the multi-period and multi-scale discriminators and the LSGAN
losses (JAX reference: models/vocoder.py).

Activations are (B, C, T), or (B, C, T/p, p) in a period discriminator (the
reference layout; the JAX package's batched-period layout is a TPU choice and
changes no score or feature-loss mean). Convs keep the weight-norm
(weight_v, weight_g) parametrisation, w = g * v / ||v||, with the norm over
every dim but 0: the output channel of a conv, the input channel of a
transposed conv (torch weight_norm's default dim=0 in both cases). The first
scale discriminator uses spectral norm instead, with its power-iteration
vector `u` a buffer. Each generator stage of at most 128 channels runs its
resblock trio through ops/fused_tail.py (the CUDA kernel on the card, under
grad with a plain-recompute backward; the plain trio on the CPU); the wider
first stage keeps the per-resblock loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_tpu_torch.core.config import VocoderConfig
from lip2speech_tpu_torch.models.layers import Linear, uniform_
from lip2speech_tpu_torch.ops import nn as ops
from lip2speech_tpu_torch.ops.fused_tail import fused_resblock_trio, resblock1_plain

LRELU_SLOPE = 0.1
FUSED_MAX_CHANNELS = 128


class _WNConv(nn.Module):
    """weight_v (dim0, dim1, *kernel), weight_g (dim0, 1, ...), bias (out,)."""

    def __init__(self, shape: tuple[int, ...], out_ch: int, fan_in: int,
                 init_std: float | None):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.fan_in, self.init_std = fan_in, init_std

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if self.init_std is not None:           # HiFi-GAN init_weights
                self.weight_v.normal_(0.0, self.init_std, generator=gen)
            else:
                uniform_(self.weight_v, self.fan_in, gen)
            self.weight_g.copy_(torch.linalg.vector_norm(self.weight_v, dim=self._norm_dims(),
                                                         keepdim=True))
        uniform_(self.bias, self.fan_in, gen)

    def _norm_dims(self) -> tuple[int, ...]:
        return tuple(range(1, self.weight_v.ndim))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * (self.weight_g / v.square().sum(dim=self._norm_dims(), keepdim=True).sqrt())


class WNConv1d(_WNConv):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, padding: int = 0,
                 dilation: int = 1, init_std: float | None = 0.01, stride: int = 1,
                 groups: int = 1):
        fan_in = in_ch // groups * kernel
        super().__init__((out_ch, in_ch // groups, kernel), out_ch, fan_in, init_std)
        self.padding, self.dilation, self.stride, self.groups = padding, dilation, stride, groups

    def forward(self, x):
        return ops.conv1d(x, self.weight(), self.bias, self.stride, self.padding,
                          self.dilation, self.groups)


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
        self.code_dropout = 0.1        # after the unit upsampler's GELU, in training
        self.dict = nn.Embedding(h.num_embeddings, h.embedding_dim)
        self.code_upsample = WNConvTranspose1d(h.embedding_dim, h.embedding_dim, 4, 2, 1,
                                               init_std=None)
        self.code_fc = Linear(h.embedding_dim, h.embedding_dim)
        self.spkr = Linear(h.embedder_dim, h.embedding_dim)
        self.generator = HiFiGANGenerator(h)

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.dict.weight.normal_(0.0, 1.0, generator=gen)

    def forward(self, code, mel, spk_emb, gen: torch.Generator | None = None):
        """code (B, Tc) int units in [0, 200); mel (B, 2Tc, 80); spk (B, 256)
        -> (B, 320 Tc) waveform in [-1, 1]. In training mode the upsampled
        units take dropout (rate `code_dropout`) drawn from `gen`; in eval
        mode nothing is drawn."""
        y = ops.gelu(self.code_upsample(self.dict(code).transpose(1, 2)))   # (B, E, 2Tc)
        if self.training:
            y = ops.dropout(y, self.code_dropout, gen)
        y = self.code_fc(y.transpose(1, 2))                      # (B, 2Tc, E)
        spk = self.spkr(spk_emb)[:, None, :].expand(-1, y.shape[1], -1)
        x = torch.cat([mel, y, spk], dim=-1).transpose(1, 2)
        return self.generator(x.contiguous())



# --------------------------------------------------------------------------
# Discriminators


class WNConv2d(_WNConv):
    """Weight-normed Conv2d, weight_v (O, I, kh, kw), norm over (I, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride, padding):
        kh, kw = kernel
        super().__init__((out_ch, in_ch, kh, kw), out_ch, in_ch * kh * kw, None)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x):
        return ops.conv2d(x, self.weight(), self.bias, self.stride, self.padding)


class SpectralConv1d(nn.Module):
    """Conv1d under torch's spectral_norm: w / sigma(w), weight (O, I/g, K),
    u (O,) a buffer. A call in training mode takes one power iteration from
    u and keeps the new u (u and v without gradient, sigma differentiable in
    w); an eval call leaves u as it is. The JAX package starts u as an
    unnormalised normal draw, and so does init_random."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.register_buffer("u", torch.empty(out_ch))
        self.stride, self.padding, self.groups = stride, padding, groups

    def init_random(self, gen: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        uniform_(self.weight, fan_in, gen)
        uniform_(self.bias, fan_in, gen)
        with torch.no_grad():
            self.u.normal_(0.0, 1.0, generator=gen)

    def normalised_weight(self) -> torch.Tensor:
        w = self.weight
        w2d = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = w2d.T @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            if self.training:
                u = w2d @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
                self.u.copy_(u)
            else:
                u = self.u.clone()     # sigma's graph keeps u; the buffer may move on
        return w / (u @ (w2d @ v))

    def forward(self, x):
        return ops.conv1d(x, self.normalised_weight(), self.bias, self.stride, self.padding,
                          1, self.groups)


def disc_conv1d(in_ch, out_ch, kernel, stride, padding, groups, spectral: bool) -> nn.Module:
    """DiscriminatorS's conv: spectral norm on the first scale, weight norm
    (torch-default uniform init) elsewhere."""
    if spectral:
        return SpectralConv1d(in_ch, out_ch, kernel, stride, padding, groups)
    return WNConv1d(in_ch, out_ch, kernel, padding, init_std=None, stride=stride, groups=groups)


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform (right-padded by reflection to a
    multiple of p) folded to (B, 1, T/p, p), then (k, 1) convs."""

    CHANNELS = (32, 128, 512, 1024)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        cin = 1
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"convs_{i}", WNConv2d(cin, ch, (5, 1), (3, 1), (2, 0)))
            cin = ch
        self.convs_4 = WNConv2d(cin, 1024, (5, 1), (1, 1), (2, 0))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x):
        """x (B, T) -> (score (B, N), feature maps (B, C, H, p))."""
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, p)
        fmap = []
        for i in range(len(self.CHANNELS) + 1):
            x = ops.leaky_relu(getattr(self, f"convs_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided conv1d stack on the waveform."""

    SPECS = ((128, 15, 1, 7, 1), (128, 41, 2, 20, 4), (256, 41, 2, 20, 16),
             (512, 41, 4, 20, 16), (1024, 41, 4, 20, 16), (1024, 41, 1, 20, 16),
             (1024, 5, 1, 2, 1))            # (out, kernel, stride, padding, groups)

    def __init__(self, spectral: bool = False):
        super().__init__()
        cin = 1
        for i, (ch, k, s, pad, g) in enumerate(self.SPECS):
            self.add_module(f"convs_{i}", disc_conv1d(cin, ch, k, s, pad, g, spectral))
            cin = ch
        self.conv_post = disc_conv1d(cin, 1, 3, 1, 1, 1, spectral)

    def forward(self, x):
        """x (B, T) -> (score (B, N), feature maps (B, C, T'))."""
        x = x[:, None]
        fmap = []
        for i in range(len(self.SPECS)):
            x = ops.leaky_relu(getattr(self, f"convs_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(p))

    def forward(self, y, y_hat):
        """Real and generated waveforms (B, T) -> (real scores, generated
        scores, real feature maps, generated feature maps), one per period."""
        outs = []
        for p in self.periods:
            d = getattr(self, f"disc_p{p}")
            (sr, fmr), (sg, fmg) = d(y), d(y_hat)
            outs.append((sr, sg, fmr, fmg))
        return tuple(map(list, zip(*outs)))


class MultiScaleDiscriminator(nn.Module):
    """Three scale discriminators, the first spectral-normed, on the
    waveform average-pooled (4, 2, 2) once more before each later one."""

    def __init__(self):
        super().__init__()
        for i in range(3):
            self.add_module(f"disc_s{i}", DiscriminatorS(spectral=i == 0))

    def forward(self, y, y_hat):
        outs = []
        for i in range(3):
            if i:
                y = ops.avg_pool1d(y[:, None], 4, 2, 2)[:, 0]
                y_hat = ops.avg_pool1d(y_hat[:, None], 4, 2, 2)[:, 0]
            d = getattr(self, f"disc_s{i}")
            (sr, fmr), (sg, fmg) = d(y), d(y_hat)
            outs.append((sr, sg, fmr, fmg))
        return tuple(map(list, zip(*outs)))


# --------------------------------------------------------------------------
# LSGAN losses (reference speech-resynthesis/models.py:356-387)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum over discriminators and layers of mean |real - generated|."""
    return 2.0 * sum((rl - gl).abs().mean() for dr, dg in zip(fmap_r, fmap_g)
                     for rl, gl in zip(dr, dg))


def discriminator_loss(real_outs, gen_outs) -> torch.Tensor:
    return sum((1.0 - dr).square().mean() + dg.square().mean()
               for dr, dg in zip(real_outs, gen_outs))


def generator_adv_loss(gen_outs) -> torch.Tensor:
    return sum((1.0 - dg).square().mean() for dg in gen_outs)
