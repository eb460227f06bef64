"""Conv1D-ResNet audio frontend, raw 16 kHz waveform -> 25 Hz features (JAX
reference: models/resnet1d.py).

The waveform is cut to a multiple of 640 samples, then Conv1d(1 -> 64, k 80,
stride 4, pad 38) + BatchNorm + act, a ResNet-18-style 1-D trunk (strides 2
at stages 2-4, 512 channels out) and an average pool of 20 / a_upsample_ratio:
640 / a samples a frame. The activation is swish, per-channel PReLU
(modules named act, act1, act2) or ReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import BatchNorm, Conv1d, activation
from lip2speech_tpu_torch.ops import nn as ops


class BasicBlock1D(nn.Module):
    """conv3-BN-act-conv3-BN + residual (1x1 conv + BN when the shape
    changes), act."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, relu_type: str = "swish"):
        super().__init__()
        self.conv1 = Conv1d(in_planes, planes, 3, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm(planes)
        self.act1 = activation(relu_type, planes)
        self.conv2 = Conv1d(planes, planes, 3, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        if stride != 1 or in_planes != planes:
            self.downsample_conv = Conv1d(in_planes, planes, 1, 0, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(planes)
        else:
            self.downsample_conv = None
        self.act2 = activation(relu_type, planes)

    def forward(self, x):
        out = self.bn2(self.conv2(self.act1(self.bn1(self.conv1(x)))))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.act2(out + residual)


class Conv1dResNetFrontend(nn.Module):
    """(B, T_samples, 1) raw 16 kHz audio -> (B, T // 640 * a, 512)."""

    def __init__(self, relu_type: str = "swish", a_upsample_ratio: int = 1):
        super().__init__()
        self.a_upsample_ratio = a_upsample_ratio
        self.stem_conv = Conv1d(1, 64, 80, 38, stride=4, bias=False)
        self.stem_bn = BatchNorm(64)
        self.act = activation(relu_type, 64)
        in_planes = 64
        for stage, (planes, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for block in range(2):
                self.add_module(f"trunk_layer{stage + 1}_{block}", BasicBlock1D(
                    in_planes, planes, stride if block == 0 else 1, relu_type))
                in_planes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        x = x[:, : t // 640 * 640].transpose(1, 2)                   # (B, 1, T)
        x = self.act(self.stem_bn(self.stem_conv(x)))
        for stage in range(1, 5):
            for block in range(2):
                x = getattr(self, f"trunk_layer{stage}_{block}")(x)
        k = 20 // self.a_upsample_ratio
        return ops.avg_pool1d(x, k, k, 0).transpose(1, 2)
