"""The multi-input HiFi-GAN generator in plain PyTorch, functional over the
port's state-dict names: unit embedding -> transposed conv x2 -> GELU ->
linear, concatenated with the mel and the projected speaker embedding ->
conv_pre -> per stage [leaky ReLU 0.1, transposed conv, mean of the
ResBlock1 outputs] -> leaky ReLU 0.01 -> conv_post -> tanh. Every conv is
weight-normed: w = g * v / ||v||, the norm over every dim but 0.

`generate(..., operand=tf32)` rounds each convolution's input and weight to
TF32 (10 mantissa bits, to nearest) first, as a TF32 convolution does, on
any device: the error that TF32 makes on these weights and inputs."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32(x):
    """x rounded to the nearest TF32 value (ties away from zero), kept in float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _keep(x):
    return x


def _wn(P, name):
    v, g = P[name + ".weight_v"], P[name + ".weight_g"]
    return v * (g / v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt())


def _conv(P, name, x, padding, dilation=1, op=_keep):
    return (F.conv1d(op(x), op(_wn(P, name)), None, 1, padding, dilation)
            + P[name + ".bias"][None, :, None])


def _up(P, name, x, stride, padding, op=_keep):
    return (F.conv_transpose1d(op(x), op(_wn(P, name)), None, stride, padding)
            + P[name + ".bias"][None, :, None])


def resblock(P, name, x, kernel, dilations, op=_keep):
    for i, d in enumerate(dilations):
        xt = _conv(P, f"{name}.convs1_{i}", F.leaky_relu(x, 0.1), (kernel * d - d) // 2, d, op)
        xt = _conv(P, f"{name}.convs2_{i}", F.leaky_relu(xt, 0.1), (kernel - 1) // 2, 1, op)
        x = x + xt
    return x


def generate(P, v: dict, code, mel, spk, operand=_keep):
    """code (B, Tc) units; mel (B, 2 Tc, 80); spk (B, 256) -> (B, Tc * 320)."""
    op = operand
    y = F.gelu(_up(P, "code_upsample", P["dict.weight"][code].transpose(1, 2), 2, 1, op))
    y = F.linear(y.transpose(1, 2), P["code_fc.weight"], P["code_fc.bias"])
    s = F.linear(spk, P["spkr.weight"], P["spkr.bias"])[:, None, :].expand(-1, y.shape[1], -1)
    x = torch.cat([mel, y, s], -1).transpose(1, 2)
    x = _conv(P, "generator.conv_pre", x, 3, 1, op)
    n_k = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = _up(P, f"generator.ups_{i}", F.leaky_relu(x, 0.1), u, (k - u) // 2, op)
        x = sum(resblock(P, f"generator.resblocks_{i * n_k + j}", x, rk, rd, op)
                for j, (rk, rd) in enumerate(zip(v["resblock_kernel_sizes"],
                                                 v["resblock_dilation_sizes"]))) / n_k
    x = _conv(P, "generator.conv_post", F.leaky_relu(x, 0.01), 3, 1, op)
    return torch.tanh(x)[:, 0]
