"""Layers with torch-layout weights (JAX reference: models/layers.py).

Parameters are allocated empty; `init_weights(module, generator)` fills them
from one explicit torch.Generator with the JAX package's initialisers (torch
defaults: uniform(+-1/sqrt(fan_in)) for conv and linear). Converted weights
(convert/from_jax.py) overwrite them anyway.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lip2speech_tpu_torch.ops import nn as ops


def uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def init_weights(root: nn.Module, gen: torch.Generator) -> None:
    """Random init of every layer under `root` that defines init_random."""
    for m in root.modules():
        init = getattr(m, "init_random", None)
        if init is not None:
            init(gen)


class Linear(nn.Module):
    """y = x W^T + b, weight (out, in). init="kaiming_fan_out" is the MLP
    head's kaiming_normal(mode='fan_out')."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "uniform"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.init = init

    def init_random(self, gen: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        with torch.no_grad():
            if self.init == "kaiming_fan_out":
                self.weight.normal_(0.0, math.sqrt(2.0 / out_f), generator=gen)
            else:
                uniform_(self.weight, in_f, gen)
        if self.bias is not None:
            uniform_(self.bias, in_f, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.bias)


class _ConvNd(nn.Module):
    """Weight (out, in/groups, *kernel); input channel-first."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, ...],
                 stride, padding, groups: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, *kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def init_random(self, gen: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            uniform_(self.bias, fan_in, gen)


class Conv1d(_ConvNd):
    def __init__(self, in_ch, out_ch, kernel: int, padding: int = 0, groups: int = 1,
                 stride: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, (kernel,), stride, padding, groups, bias)

    def forward(self, x):
        return ops.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                          groups=self.groups)


class ConvTranspose1d(nn.Module):
    """Weight (in, out, K), torch.nn.ConvTranspose1d's layout; fan-in in x K
    at init, as the JAX layer's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.stride, self.padding = stride, padding

    def init_random(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[0] * self.weight.shape[2]
        uniform_(self.weight, fan_in, gen)
        uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        return ops.conv_transpose1d(x, self.weight, self.bias, self.stride, self.padding)


class Conv2d(_ConvNd):
    def __init__(self, in_ch, out_ch, kernel, stride=(1, 1), padding=(0, 0),
                 bias: bool = True, groups: int = 1):
        super().__init__(in_ch, out_ch, tuple(kernel), tuple(stride),
                         tuple(padding), groups, bias)

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class Conv3d(_ConvNd):
    def __init__(self, in_ch, out_ch, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), bias: bool = False):
        super().__init__(in_ch, out_ch, tuple(kernel), tuple(stride),
                         tuple(padding), bias=bias)

    def forward(self, x):
        return ops.conv3d(x, self.weight, self.bias, self.stride, self.padding)


def _data_group():
    """The active mesh's data-axis group when it spans more than one rank."""
    from lip2speech_tpu_torch.parallel.mesh import DATA_AXIS, active_mesh

    mesh = active_mesh()
    if mesh is None or not mesh.distributed or mesh.shape[DATA_AXIS] == 1:
        return None
    return mesh.data_group


class BatchNorm(nn.Module):
    """Batch norm over channel dim 1 (eps 1e-5, momentum 0.1), with only the
    running statistics as buffers, as in the JAX tree. In training mode it
    normalises with the batch statistics and updates the buffers in place
    (f32 arithmetic, stored in the buffers' type); in eval mode it reads
    them. Inside `parallel.use_mesh(mesh)` with a data axis of more than one
    rank, the batch statistics are those of the whole batch across the data
    axis (ops.batch_norm_train's group); the model axis, whose ranks hold the
    same rows, is not reduced over. torch.nn.SyncBatchNorm cannot serve: it
    refuses CPU tensors and keeps no f32 statistics for bf16 input."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))
        self.eps, self.momentum = eps, momentum

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            y, mean, var = ops.batch_norm_train(x, self.running_mean, self.running_var,
                                                self.weight, self.bias, self.eps, self.momentum,
                                                group=_data_group())
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
            return y
        return ops.batch_norm(x, self.running_mean, self.running_var,
                              self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim; eps 1e-12 (ESPnet) unless given (the
    wav2vec2-style modules pass fairseq's 1e-5)."""

    def __init__(self, features: int, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.eps = eps

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


class PReLU(nn.Module):
    """Per-channel PReLU over channel dim 1, alpha 0.25 at init."""

    def __init__(self, features: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))

    def init_random(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x):
        return ops.prelu(x, self.weight)


def activation(name: str, features: int | None = None):
    """Activation factory over the relu_type choices; "prelu" is a module
    with parameters, the others are plain functions."""
    if name == "swish":
        return ops.swish
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return ops.gelu
    if name == "prelu":
        return PReLU(features or 1)
    raise ValueError(f"unknown activation {name!r}")
