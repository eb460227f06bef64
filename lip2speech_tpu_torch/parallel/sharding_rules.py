"""Parameter sharding rules: head-parallel tensor parallelism for the
transformer stacks (JAX reference: parallel/sharding_rules.py).

The JAX rule table, on the port's names and in the port's layout. A port
Linear's weight is (out, in) where the JAX one is (in, out), so the JAX
P(None, 'model') of a column-parallel weight is a split of the port's dim 0,
and P('model', None) of a row-parallel one a split of dim 1:

  FFN:      w_1 / fc1 (ffn, d) -> P('model', None)   column-parallel, bias split too
            w_2 / fc2 (d, ffn) -> P(None, 'model')   row-parallel, bias added after the sum
  attention q/k/v (d, d)       -> P('model', None)   heads split over 'model', biases too
            out   (d, d)       -> P(None, 'model')
            pos_bias_u/v (H, dk) -> P('model', None) the rank's heads

The q/k/v biases and pos_bias_u/v, which the JAX rules leave replicated,
are split with their heads here: GSPMD can slice a replicated operand, a
local matmul cannot. linear_pos stays replicated, as in JAX; each rank
takes its heads of its output.

The split happens per block: a module that defines `tp_parts()` (the
conformer's RelPositionMultiHeadAttention and FeedForward, AV-HuBERT's
SelfAttention and TransformerLayer's FFN) is split when its parts (heads,
or hidden units) divide the model axis, and otherwise stays replicated
whole, where the JAX rules fall back per leaf. A parameter that matches a
rule outside such a module (MLPHead's fc1) stays replicated.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.parallel.collectives import TensorParallel
from lip2speech_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, NamedSharding, P

COLUMN, ROW, VECTOR = P(MODEL_AXIS, None), P(None, MODEL_AXIS), P(MODEL_AXIS)

# (name-suffix match, spec) — first hit wins, on the dotted name split at "."
_RULES = [
    # conformer FFN
    (("feed_forward", "w_1", "weight"), COLUMN),
    (("feed_forward", "w_1", "bias"), VECTOR),
    (("feed_forward", "w_2", "weight"), ROW),
    (("feed_forward_macaron", "w_1", "weight"), COLUMN),
    (("feed_forward_macaron", "w_1", "bias"), VECTOR),
    (("feed_forward_macaron", "w_2", "weight"), ROW),
    # conformer attention (head-parallel)
    (("self_attn", "linear_q", "weight"), COLUMN),
    (("self_attn", "linear_k", "weight"), COLUMN),
    (("self_attn", "linear_v", "weight"), COLUMN),
    (("self_attn", "linear_q", "bias"), VECTOR),
    (("self_attn", "linear_k", "bias"), VECTOR),
    (("self_attn", "linear_v", "bias"), VECTOR),
    (("self_attn", "pos_bias_u"), COLUMN),
    (("self_attn", "pos_bias_v"), COLUMN),
    (("self_attn", "linear_out", "weight"), ROW),
    # wav2vec2-style attention/FFN
    (("self_attn", "q_proj", "weight"), COLUMN),
    (("self_attn", "k_proj", "weight"), COLUMN),
    (("self_attn", "v_proj", "weight"), COLUMN),
    (("self_attn", "q_proj", "bias"), VECTOR),
    (("self_attn", "k_proj", "bias"), VECTOR),
    (("self_attn", "v_proj", "bias"), VECTOR),
    (("self_attn", "out_proj", "weight"), ROW),
    (("fc1", "weight"), COLUMN),
    (("fc1", "bias"), VECTOR),
    (("fc2", "weight"), ROW),
]


def _spec_for(name: str, ndim: int) -> P:
    path = tuple(name.split("."))
    for suffix, spec in _RULES:
        if path[-len(suffix):] == suffix:
            return spec if len(spec) <= ndim else P()
    return P()


def param_specs(params) -> dict[str, P]:
    """PartitionSpec of every parameter by name (a module, or a dict of name
    -> tensor), from the rule table alone."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: _spec_for(name, t.ndim) for name, t in params.items()}


def _owners(model: nn.Module) -> dict[str, str]:
    """Parameter name -> the name of its deepest enclosing module that can
    be split (has tp_parts), for the parameters that have one."""
    blocks = [name for name, m in model.named_modules() if hasattr(m, "tp_parts")]
    owners = {}
    for pname, _ in model.named_parameters():
        inside = [b for b in blocks if pname.startswith(b + ".")]
        if inside:
            owners[pname] = max(inside, key=len)
    return owners


def _split_dims(model: nn.Module, model_size: int) -> tuple[dict[str, int], set[str]]:
    """({parameter name: dim split over the model axis}, names of the blocks
    split) for a model axis of model_size."""
    if model_size == 1:
        return {}, set()
    modules = dict(model.named_modules())
    owners = _owners(model)
    split = {b for b in set(owners.values()) if modules[b].tp_parts() % model_size == 0}
    dims = {}
    for name, spec in param_specs(model).items():
        if MODEL_AXIS in spec and owners.get(name) in split:
            dims[name] = spec.index(MODEL_AXIS)
    return dims, split


def param_shardings(model: nn.Module, mesh: Mesh) -> dict[str, NamedSharding]:
    """NamedSharding of every parameter as shard_params splits it: the rule's
    spec inside a block that is split, P() elsewhere."""
    dims, _ = _split_dims(model, mesh.shape[MODEL_AXIS])
    specs = param_specs(model)
    return {name: NamedSharding(mesh, specs[name] if name in dims else P())
            for name in specs}


def _part(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    return t.chunk(size, dim)[index]


def shard_params(model: nn.Module, mesh: Mesh) -> dict[str, int]:
    """Keep the calling rank's part of every split parameter of `model` (in
    place) and give each split block its TensorParallel; returns {name: dim
    split}. A mesh whose model axis is 1 changes nothing."""
    size = mesh.shape[MODEL_AXIS]
    dims, split = _split_dims(model, size)
    if not dims:
        return {}
    index = mesh.model_index
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in dims.items():
            params[name].data = _part(params[name].data, dim, index, size).contiguous()
    modules = dict(model.named_modules())
    for b in split:
        modules[b].tp = TensorParallel(mesh.model_group, index, size)
    return dims


def gather_params(tensors: dict[str, torch.Tensor], dims: dict[str, int],
                  mesh: Mesh) -> dict[str, torch.Tensor]:
    """The whole of every split tensor (the rank's parts put in place in
    zeros and summed over the model group; the others as they are). Every
    rank of the model group calls it."""
    import torch.distributed as dist

    size, index = mesh.shape[MODEL_AXIS], mesh.model_index
    out = dict(tensors)
    for name, dim in dims.items():
        part = tensors[name]
        shape = list(part.shape)
        shape[dim] *= size
        whole = part.new_zeros(shape)
        _part(whole, dim, index, size).copy_(part)
        dist.all_reduce(whole, group=mesh.model_group)
        out[name] = whole
    return out


def split_params(tensors: dict[str, torch.Tensor], dims: dict[str, int],
                 mesh: Mesh) -> dict[str, torch.Tensor]:
    """The calling rank's part of every split tensor; the others as they are."""
    size, index = mesh.shape[MODEL_AXIS], mesh.model_index
    return {name: (_part(t, dims[name], index, size).contiguous() if name in dims else t)
            for name, t in tensors.items()}
