"""ShuffleNetV2 video frontend, the light alternative to the ResNet-18
trunk (JAX reference: models/shufflenet.py).

(B, T, H, W, 1) mouth crops -> Conv3d(1 -> 24, (5, 7, 7)) + BatchNorm +
swish (or ReLU) + max pool over time, then per frame stages of [4, 8, 4]
InvertedResidual split/shuffle units, a 1x1 conv to 1024 and a spatial
mean -> (B, T, 1024). Channel-first (N, C, H, W) inside; channel_shuffle
gives the channel order of the JAX package's channel-last version.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import BatchNorm, Conv2d, Conv3d
from lip2speech_tpu_torch.ops import nn as ops

STAGE_REPEATS = (4, 8, 4)
STAGE_CHANNELS = {0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
                  1.5: (176, 352, 704, 1024), 2.0: (244, 488, 976, 2048)}


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """(N, C, H, W): channel i * (C / groups) + j moves to j * groups + i."""
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class _ConvBNRelu(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, relu: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, (kernel, kernel), (stride, stride),
                           (padding, padding), bias=False, groups=groups)
        self.bn = BatchNorm(out_ch)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class InvertedResidual(nn.Module):
    """ShuffleNetV2 unit. downsample (benchmodel 2): both branches see the
    whole input, the first through a depthwise 3x3; otherwise the channels
    split in two halves and the second half takes the branch. The branches'
    outputs are concatenated and shuffled."""

    def __init__(self, in_ch: int, out_channels: int, stride: int, downsample: bool):
        super().__init__()
        half = out_channels // 2
        self.downsample = downsample
        if downsample:
            self.b1_dw = _ConvBNRelu(in_ch, in_ch, 3, stride, 1, groups=in_ch, relu=False)
            self.b1_pw = _ConvBNRelu(in_ch, half, 1)
            branch_in = in_ch
        else:
            branch_in = half
        self.b2_pw1 = _ConvBNRelu(branch_in, half, 1)
        self.b2_dw = _ConvBNRelu(half, half, 3, stride, 1, groups=half, relu=False)
        self.b2_pw2 = _ConvBNRelu(half, half, 1)

    def forward(self, x):
        if self.downsample:
            x1, x2 = self.b1_pw(self.b1_dw(x)), x
        else:
            x1, x2 = x.chunk(2, dim=1)
        y = self.b2_pw2(self.b2_dw(self.b2_pw1(x2)))
        return channel_shuffle(torch.cat([x1, y], dim=1), 2)


class ShuffleNetV2Trunk(nn.Module):
    """(N, 24, H, W) post-stem feature maps -> (N, out_dim) pooled features."""

    def __init__(self, width_mult: float = 1.0, in_ch: int = 24):
        super().__init__()
        chans = STAGE_CHANNELS[width_mult]
        for stage, (reps, out_ch) in enumerate(zip(STAGE_REPEATS, chans[:3])):
            for i in range(reps):
                self.add_module(f"stage{stage + 2}_{i}", InvertedResidual(
                    in_ch, out_ch, 2 if i == 0 else 1, i == 0))
                in_ch = out_ch
        self.conv_last = _ConvBNRelu(in_ch, chans[3], 1)

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x.mean(dim=(2, 3))


class ShuffleNet3DFrontend(nn.Module):
    """Conv3dResNet(backbone_type='shufflenet'): (B, T, H, W, 1) -> (B, T, 1024)."""

    def __init__(self, width_mult: float = 1.0, relu_type: str = "swish"):
        super().__init__()
        self.relu_type = relu_type
        self.stem_conv = Conv3d(1, 24, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False)
        self.stem_bn = BatchNorm(24)
        self.trunk = ShuffleNetV2Trunk(width_mult)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t = video.shape[:2]
        x = self.stem_bn(self.stem_conv(video.permute(0, 4, 1, 2, 3)))     # (B, 24, T, H, W)
        x = ops.swish(x) if self.relu_type == "swish" else torch.relu(x)
        x = ops.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        c, h, w = x.shape[1], x.shape[3], x.shape[4]
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        return self.trunk(x).reshape(b, t, -1)
