"""3D-conv + ResNet-18 visual frontend (JAX reference: models/resnet3d.py).

(B, T, 88, 88, 1) mouth crops -> (B, T, 512) per-frame features, with the
conformer-only model's swish activations or AV-HuBERT's per-channel PReLU
(relu_type; the PReLU modules are named act, act1, act2). The stem runs over time in
(B, C, T, H, W); the 2-D trunk runs with time folded into the batch, then a
spatial mean.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import BatchNorm, Conv2d, Conv3d, activation
from lip2speech_tpu_torch.ops import nn as ops


class BasicBlock(nn.Module):
    """conv3x3-BN-act-conv3x3-BN + residual, act."""

    def __init__(self, in_planes: int, planes: int, stride: int, relu_type: str = "swish"):
        super().__init__()
        self.act1 = activation(relu_type, planes)
        self.act2 = activation(relu_type, planes)
        self.conv1 = Conv2d(in_planes, planes, (3, 3), (stride, stride), (1, 1), bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, (3, 3), (1, 1), (1, 1), bias=False)
        self.bn2 = BatchNorm(planes)
        if stride != 1 or in_planes != planes:
            self.downsample_conv = Conv2d(in_planes, planes, (1, 1), (stride, stride),
                                          (0, 0), bias=False)
            self.downsample_bn = BatchNorm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = self.act1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.act2(out + residual)


class ResNetTrunk(nn.Module):
    """Four stages of two basic blocks, 64 -> 512 channels, spatial mean."""

    def __init__(self, relu_type: str = "swish"):
        super().__init__()
        in_planes = 64
        for stage, (planes, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            for block in range(2):
                self.add_module(f"layer{stage + 1}_{block}", BasicBlock(
                    in_planes, planes, stride if block == 0 else 1, relu_type))
                in_planes = planes

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x.mean(dim=(2, 3))


class ResNet3DFrontend(nn.Module):
    def __init__(self, relu_type: str = "swish"):
        super().__init__()
        self.stem_conv = Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False)
        self.stem_bn = BatchNorm(64)
        self.act = activation(relu_type, 64)
        self.trunk = ResNetTrunk(relu_type)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, T, H, W, 1) -> (B, T, 512)."""
        b, t = video.shape[:2]
        x = video.permute(0, 4, 1, 2, 3)                     # (B, 1, T, H, W)
        x = self.act(self.stem_bn(self.stem_conv(x)))
        x = ops.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        c, h, w = x.shape[1], x.shape[3], x.shape[4]
        x = x.transpose(1, 2).reshape(b * t, c, h, w)
        return self.trunk(x).reshape(b, t, -1)
