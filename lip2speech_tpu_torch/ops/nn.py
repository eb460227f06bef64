"""Neural-net primitives of the port (JAX reference: lip2speech_tpu/ops/nn.py).

Convolutions take PyTorch's channel-first layout, (B, C, T) / (B, C, H, W) /
(B, C, T, H, W), with weights (Cout, Cin/groups, *kernel). The bias is added
after the convolution, in the activation dtype, as the JAX ops do. The JAX
package's matrix-unit reshapes (conv3d_timestack, conv1d_timestack,
conv1d_group_packed and ops/fold_conv.py) have no counterpart here: they only
suit the TPU; cuDNN runs Cin=1 and grouped convs as they are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _add_bias(y: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if b is None:
        return y
    return y + b.reshape((1, -1) + (1,) * (y.ndim - 2))


def conv1d(x, w, b=None, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """(B, Cin, T) x (Cout, Cin/groups, K) -> (B, Cout, T'); torch.nn.Conv1d."""
    return _add_bias(F.conv1d(x, w, None, stride, padding, dilation, groups), b)


def conv_transpose1d(x, w, b=None, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """(B, Cin, T) x (Cin, Cout, K) -> (B, Cout, (T-1)*stride - 2*padding + K)."""
    return _add_bias(F.conv_transpose1d(x, w, None, stride, padding), b)


def conv2d(x, w, b=None, stride=1, padding=0, groups: int = 1) -> torch.Tensor:
    return _add_bias(F.conv2d(x, w, None, stride, padding, 1, groups), b)


def conv3d(x, w, b=None, stride=(1, 1, 1), padding=(0, 0, 0)) -> torch.Tensor:
    return _add_bias(F.conv3d(x, w, None, stride, padding), b)


def batch_norm(x, mean, var, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode batch norm over channel dim 1. Statistics kept in f32
    beside bf16 weights (bf16 training) are read in the input's type."""
    if mean.dtype != x.dtype:
        mean, var = mean.to(x.dtype), var.to(x.dtype)
    return F.batch_norm(x, mean, var, gamma, beta, False, 0.0, eps)


def batch_norm_train(x, running_mean, running_var, gamma, beta, eps: float = 1e-5,
                     momentum: float = 0.1, group=None):
    """Training-mode batch norm over channel dim 1; returns (y, new_mean,
    new_var). The batch statistics and the running update are f32 whatever
    the input type (a bf16 momentum update would round small drifts away);
    the normalisation stays on the input's type. running_var takes the
    unbiased batch variance, as torch.nn.BatchNorm does.

    With a process group the statistics are those of the batch of every rank
    of it, as GSPMD gives the JAX mesh step: the sum, the sum of squares and
    the count are summed over the group by an all-reduce whose backward sums
    the gradients too, and the running variance is unbiased over the global
    count."""
    reduce_dims = [d for d in range(x.ndim) if d != 1]
    n = x.numel() // x.shape[1]
    x32 = x.float()
    if group is None:
        mean = x32.mean(dim=reduce_dims)
        var = x32.square().mean(dim=reduce_dims) - mean.square()
    else:
        from lip2speech_tpu_torch.parallel.collectives import all_reduce_sum

        c = x.shape[1]
        sums = all_reduce_sum(torch.cat([x32.sum(dim=reduce_dims), x32.square().sum(dim=reduce_dims),
                                         x32.new_full((1,), float(n))]), group)
        n = sums[-1]                                   # the global count, on the device
        mean = sums[:c] / n
        var = sums[c: 2 * c] / n - mean.square()
    shape = (1, -1) + (1,) * (x.ndim - 2)
    scale = (torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)
    y = (x - mean.to(x.dtype).reshape(shape)) * scale.reshape(shape) + beta.reshape(shape)
    unbiased = var * (n / (n - 1.0).clamp(min=1.0) if group is not None else n / max(n - 1.0, 1.0))
    new_mean = (1 - momentum) * running_mean.float() + momentum * mean
    new_var = (1 - momentum) * running_var.float() + momentum * unbiased
    return y, new_mean.detach(), new_var.detach()


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            shard: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Inverted dropout whose mask comes from an explicit generator on x's
    device (F.dropout takes none); gen=None draws from the device's default
    generator. shard=(dim, index, parts): x is part `index` of `parts`
    equal slices along dim of a tensor split over the model axis; the mask
    of the whole tensor is drawn and x's part kept, so the ranks, which share
    a generator, drop independent units and stay in step."""
    if rate == 0.0:
        return x
    if shard is None:
        keep = torch.rand(x.shape, device=x.device, generator=gen) >= rate
    else:
        dim, index, parts = shard
        shape = list(x.shape)
        shape[dim] *= parts
        keep = (torch.rand(shape, device=x.device, generator=gen) >= rate).chunk(parts, dim)[index]
    return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)


def drop_path(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth: one keep decision per sample (dim 0)."""
    if rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = torch.rand(shape, device=x.device, generator=gen) >= rate
    return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)


IMAGE_MEAN, IMAGE_STD = 0.421, 0.165       # grayscale mouth-crop normalisation


def dequantize_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 wire-format video -> normalised float32 on its device,
    (x / 255 - mean) / std; float input passes through unchanged."""
    if video.dtype != torch.uint8:
        return video
    return (video.float() / 255.0 - IMAGE_MEAN) / IMAGE_STD


def layer_norm(x, gamma, beta, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last dim; eps is ESPnet's 1e-12."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x where x >= 0, else alpha * x, with one alpha per channel (dim 1)."""
    return torch.where(x >= 0, x, alpha.reshape((1, -1) + (1,) * (x.ndim - 2)) * x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def avg_pool1d(x, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """(B, C, T) average pool, zero padding counted (torch AvgPool1d's
    count_include_pad=True)."""
    return F.avg_pool1d(x, kernel, stride, padding, count_include_pad=True)


def max_pool3d(x, kernel=(1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)):
    """(B, C, T, H, W) max pool; torch pads with -inf."""
    return F.max_pool3d(x, kernel, stride, padding)


@functools.lru_cache(maxsize=16)
def sinusoidal_rel_pos_encoding(length: int, d_model: int) -> np.ndarray:
    """Transformer-XL symmetric relative positions, (2L-1, d): row 0 is
    relative position +(L-1), the last row -(L-1) (ESPnet
    RelPositionalEncoding). Cached per (length, d_model); do not modify."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(np.log(10000.0) / d_model))
    pe_pos = np.zeros((length, d_model), dtype=np.float32)
    pe_pos[:, 0::2] = np.sin(pos * div)
    pe_pos[:, 1::2] = np.cos(pos * div)
    pe_neg = np.zeros((length, d_model), dtype=np.float32)
    pe_neg[:, 0::2] = np.sin(-pos * div)
    pe_neg[:, 1::2] = np.cos(-pos * div)
    out = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    out.setflags(write=False)
    return out


def branch_paddings(kernel: int, dilation: int) -> tuple[int, int]:
    """torch get_padding of the (dilated, plain) conv pair of one HiFi-GAN
    ResBlock1 branch (JAX reference: ops/fold_conv.py:152)."""
    return (kernel * dilation - dilation) // 2, (kernel - 1) // 2
