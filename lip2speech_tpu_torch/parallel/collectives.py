"""The collectives the port places by hand where GSPMD inserts them in the
JAX package: differentiable all-reduces for tensor parallelism and the
cross-rank BatchNorm, and the bucketed all-reduce of flat gradients."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

BUCKET_BYTES = 64 * 2 ** 20       # flat gradient buckets of at most 64 MiB


@dataclass(frozen=True)
class TensorParallel:
    """A block split over the model axis: this rank holds part `index` of
    `size` (heads, or FFN hidden units) and sums partial outputs over `group`."""
    group: Any
    index: int
    size: int


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-parallel
    block, which every rank of the group reads whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums a row-parallel
    block leaves on each rank of the group."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp.group)


def row_parallel(x: torch.Tensor, linear, tp: TensorParallel) -> torch.Tensor:
    """A row-parallel Linear: the rank's columns of its weight on the rank's
    features, the partial sums added over the group, then the bias, once."""
    y = reduce_from_model(torch.nn.functional.linear(x, linear.weight), tp)
    return y if linear.bias is None else y + linear.bias


class _AllReduceSum(torch.autograd.Function):
    """All-reduce forward and backward: a sum over the group of a quantity
    every rank's loss depends on (torch.distributed.nn.functional.all_reduce,
    which this torch deprecates)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` whose backward sums the gradients over it too."""
    return _AllReduceSum.apply(x, group)


def all_reduce_flat(tensors: list[torch.Tensor], group, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every tensor over `group` in place, flattened into buckets of at
    most bucket_bytes (one all-reduce a bucket, tensors in their order)."""
    import torch.distributed as dist

    bucket: list[torch.Tensor] = []
    size = 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes or t.dtype != bucket[0].dtype):
            flush()
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    flush()
