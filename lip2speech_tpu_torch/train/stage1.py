"""Stage-1 training on one card: gradient accumulation, AdamW, cosine
schedule (JAX reference: train/stage1.py).

One `train_step` consumes a batch whose leaves carry a leading accumulation
axis, (accum, micro_batch, ...): it runs forward and backward per micro-batch,
sums the gradients of the summed loss, divides them by the summed sample size
(sentences, as fairseq does), clips their global norm, and takes one AdamW
update (0.9, 0.98, eps 1e-8, decoupled weight decay 0.01) at the rate of a
linear warm-up and cosine decay. BatchNorm running statistics carry from
micro-batch to micro-batch. Parameters of a frozen frontend get no gradient
and no update. With `bf16_compute` the forward and backward run on a bf16
copy of the f32 master weights made inside the loss, so the gradients come
back f32; BatchNorm statistics, losses and the optimizer stay f32.

The entry points run on the card unless the caller passes device="cpu", and
raise without one. On the card the conformer's attention runs the
hand-written forward and backward kernels with dropout inside them. The
state is updated in place.

With a mesh of ranks (parallel/mesh.py) the step is the JAX mesh step's
arithmetic: each rank takes its rows of every micro-batch (the data axis)
and, over the model axis, its heads and FFN units (parallel/sharding_rules.py);
BatchNorm takes its statistics over the data axis; after the last
micro-batch the gradients and the sample size are summed over the data axis
(bucketed all-reduces of the flat gradients, once an update), and the
gradients are divided by the global sample size; the clip norm and the logs
are global. Each data index draws its own noise (seed + data index), which
its model-axis ranks share. Without a mesh the step is the single-card one,
unchanged.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from lip2speech_tpu_torch.core.config import PipelineConfig, Stage1TrainConfig
from lip2speech_tpu_torch.data.transforms import UINT8_FILL
from lip2speech_tpu_torch.models.layers import init_weights
from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
from lip2speech_tpu_torch.ops.nn import dequantize_video
from lip2speech_tpu_torch.parallel.collectives import all_reduce_flat
from lip2speech_tpu_torch.parallel.mesh import Mesh, require_ranks, shard_batch, use_mesh
from lip2speech_tpu_torch.parallel.sharding_rules import shard_params
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device
from lip2speech_tpu_torch.train.losses import label_smoothed_ce, stage1_loss, unit_accuracy


@dataclass
class TrainState:
    step: int                          # optimizer updates taken
    model: MultiTargetModel            # f32 master weights and running statistics
    optimizer: torch.optim.Optimizer
    gen: torch.Generator               # source of the training noise, on the model's device
    seed_gen: torch.Generator          # on the CPU: the attention-dropout seeds the kernels take
    mesh: Mesh | None = None           # the ranks the state is spread over
    sharded: dict[str, int] = field(default_factory=dict)   # parameter -> dim split over 'model'

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def lr_schedule(cfg: Stage1TrainConfig) -> Callable[[int], float]:
    """fairseq cosine rate as a function of the number of updates already
    taken: linear from 0 to cfg.lr over the warm-up, then half a cosine down
    to cfg.lr / 1000 at max_updates, constant after. The first update runs at
    rate 0."""
    warmup = min(cfg.warmup_updates, max(cfg.max_updates - 1, 1))
    decay = max(cfg.max_updates, cfg.warmup_updates + 1) - warmup
    peak, alpha = cfg.lr, 1e-3

    def rate(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return rate


def trained_parameters(model: MultiTargetModel) -> list[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(cfg: Stage1TrainConfig, model: MultiTargetModel,
                   frontend_frozen: bool) -> torch.optim.Optimizer:
    """AdamW over the trained parameters; a frozen frontend's parameters are
    switched off (requires_grad False) and left out. The rate is set per
    update by train_step."""
    if frontend_frozen:
        for m in model.frontend_modules():
            m.requires_grad_(False)
    return torch.optim.AdamW(trained_parameters(model), lr=0.0,
                             betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                             weight_decay=cfg.weight_decay)


def create_train_state(cfg: PipelineConfig, seed: int | None = None,
                       device: str | torch.device | None = None,
                       state_dict: dict[str, torch.Tensor] | None = None,
                       mesh: Mesh | None = None) -> TrainState:
    """Model, optimizer and noise generator on `device` (None: the card).
    Weights come from state_dict (loaded strict, in the single-card layout)
    or, without one, from a torch.Generator seeded with `seed` (default
    cfg.stage1.seed) on the CPU, so a seed gives the same weights on every
    machine. With a mesh of ranks each rank keeps its part of the split
    parameters, and its noise generators are seeded with seed + its data
    index."""
    dev = resolve_device(device)
    seed = cfg.stage1.seed if seed is None else seed
    model = MultiTargetModel(cfg.model)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    sharded = {}
    if mesh is not None:
        sharded = shard_params(model, mesh)
        seed += mesh.data_index
    model.to(dev).train()
    optimizer = make_optimizer(cfg.stage1, model, cfg.model.frontend.frozen)
    gen = torch.Generator(device=dev).manual_seed(seed)
    seed_gen = torch.Generator().manual_seed(seed)
    return TrainState(step=0, model=model, optimizer=optimizer, gen=gen, seed_gen=seed_gen,
                      mesh=mesh, sharded=sharded)


def _to_device(micro: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in micro.items()}


def _forward(model, micro: dict, bf16: bool, gen, seed_gen) -> dict:
    """Model outputs in f32 for one micro-batch on the model's device."""
    video, spk = dequantize_video(micro["video"]), micro["spk_emb"]
    if not bf16:
        return model(video, micro["frames_mask"], spk, gen=gen, seed_gen=seed_gen)
    # a bf16 copy of the f32 weights inside the graph: the cast's backward
    # returns f32 gradients to the master weights; buffers (BatchNorm
    # statistics) stay f32
    cast = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()
            if p.dtype == torch.float32}
    out = torch.func.functional_call(
        model, cast, (video.to(torch.bfloat16), micro["frames_mask"], spk.to(torch.bfloat16)),
        {"gen": gen, "seed_gen": seed_gen})
    return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in out.items()}


def _global_norm(state: TrainState, params, grads) -> torch.Tensor:
    """The 2-norm of the whole gradient: with parameters split over the model
    axis, the squares of the split ones are summed over it and the
    replicated ones, which every rank holds whole, counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if not state.sharded:
        return torch.linalg.vector_norm(norms)
    import torch.distributed as dist

    names = {p: n for n, p in state.model.named_parameters()}
    split = torch.tensor([names[p] in state.sharded for p in params], device=norms.device)
    squares = norms.square()
    split_sum = squares[split].sum()
    dist.all_reduce(split_sum, group=state.mesh.model_group)
    return (split_sum + squares[~split].sum()).sqrt()


def make_train_step(cfg: PipelineConfig, mesh: Mesh | None = None):
    """Returns train_step(state, batch) -> (state, logs). batch leaves are
    numpy arrays or tensors of shape (accum, micro_batch, ...): video (uint8
    wire format or normalised float), frames_mask, spk_emb, unit_tokens, mel,
    optionally text_labels / text_lengths. logs are 0-d tensors on the
    state's device: the sums over the accumulation axis of stage1_loss's
    logs, plus sample_size and the grad_norm of the divided gradients (before
    clipping). state is updated in place. With a mesh of ranks every rank
    passes the same (global) batch and takes its rows; the micro-batch must
    divide the data axis, and the logs are those of the global batch."""
    require_ranks(mesh)
    s1 = cfg.stage1
    pad_id = cfg.model.units.pad
    rate = lr_schedule(s1)

    def train_step(state: TrainState, batch: dict):
        model, dev = state.model, state.device
        params = trained_parameters(model)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            batch = shard_batch(mesh, batch, axis=1)
        accum = batch["video"].shape[0]
        ss_sum = torch.zeros((), device=dev)
        log_sums: dict[str, torch.Tensor] = {}
        with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            for i in range(accum):
                micro = _to_device({k: v[i] for k, v in batch.items()}, dev)
                outputs = _forward(model, micro, s1.bf16_compute, state.gen, state.seed_gen)
                loss, sample_size, logs = stage1_loss(
                    outputs, micro, pad_id, label_smoothing=s1.label_smoothing,
                    mel_weight=s1.mel_weight, text_weight=s1.text_weight,
                    sentence_avg=s1.sentence_avg)
                loss.backward()                       # sums into .grad over micro-batches
                ss_sum = ss_sum + sample_size
                for k, v in logs.items():
                    log_sums[k] = log_sums.get(k, 0) + v.detach()
        # gradients of the summed loss over the total sample size, then the clip
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p, g in zip(params, grads):
            p.grad = g
        if mesh is not None:                      # sums over the data axis, once an update
            all_reduce_flat([ss_sum, *log_sums.values(), *grads], mesh.data_group)
        torch._foreach_div_(grads, ss_sum.clamp(min=1.0))
        grad_norm = _global_norm(state, params, grads)
        clip = torch.where(grad_norm < s1.clip_norm, 1.0, s1.clip_norm / grad_norm)
        torch._foreach_mul_(grads, clip)
        for group in state.optimizer.param_groups:
            group["lr"] = rate(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {**log_sums, "sample_size": ss_sum, "grad_norm": grad_norm}

    return train_step


def _pad_value(k: str, v: np.ndarray, pad_id: int):
    if k == "unit_tokens":
        return pad_id
    if v.dtype == np.bool_:
        return False
    if k == "video" and v.dtype == np.uint8:
        return UINT8_FILL
    return 0


def pad_batch_rows(batch: dict, bsz: int, pad_id: int) -> dict:
    """Pad the batch dimension up to bsz with dummy rows (host numpy). Dummy
    rows are all masked (frames_mask False, unit_tokens all pad), so they add
    exactly zero loss and zero sample_size."""
    b = batch["video"].shape[0]
    if b >= bsz:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "ids":
            out[k] = list(v) + [""] * (bsz - b)
            continue
        pad = [(0, 0)] * v.ndim
        pad[0] = (0, bsz - b)
        out[k] = np.pad(v, pad, constant_values=_pad_value(k, v, pad_id))
    return out


def stack_accum(batches: list[dict], pad_id: int | None = None,
                batch_size: int | None = None) -> dict:
    """Stack host micro-batches into the (accum, B, ...) layout. With pad_id,
    micro-batches that differ in batch size or length are padded first: rows
    with zero-loss dummies (up to batch_size when given), time with masked
    padding (unit_tokens to 2T+1, mel to 4T)."""
    if pad_id is not None:
        t = max(b["video"].shape[1] for b in batches)
        bsz = batch_size or max(b["video"].shape[0] for b in batches)
        targets = {"video": t, "frames_mask": t, "unit_tokens": 2 * t + 1, "mel": 4 * t}
        padded = []
        for b in batches:
            b = pad_batch_rows(b, bsz, pad_id)
            if b["video"].shape[1] != t:
                nb = {}
                for k, v in b.items():
                    if k in targets:
                        pad = [(0, 0)] * v.ndim
                        pad[1] = (0, targets[k] - v.shape[1])
                        v = np.pad(v, pad, constant_values=_pad_value(k, v, pad_id))
                    nb[k] = v
                b = nb
            padded.append(b)
        batches = padded
    keys = [k for k in batches[0] if k != "ids"]
    return {k: np.stack([b[k] for b in batches]) for k in keys}


def make_eval_step(cfg: PipelineConfig):
    """Returns eval_step(model, batch) -> (n_correct, n_valid, nll_sum) as
    0-d tensors, on one batch (no accumulation axis), in eval mode."""
    pad_id = cfg.model.units.pad

    @torch.no_grad()
    def eval_step(model: MultiTargetModel, batch: dict):
        was_training = model.training
        model.eval()
        try:
            micro = _to_device(batch, next(model.parameters()).device)
            outputs = model(dequantize_video(micro["video"]), micro["frames_mask"],
                            micro["spk_emb"])
        finally:
            model.train(was_training)
        _, nll, _ = label_smoothed_ce(outputs["unit_logits"], micro["unit_tokens"], pad_id)
        n_correct, total = unit_accuracy(outputs["unit_logits"], micro["unit_tokens"], pad_id)
        return n_correct, total, nll

    return eval_step


def evaluate(state: TrainState, ds, batch_size: int, cfg: PipelineConfig,
             eval_step=None) -> dict:
    """Unit accuracy and NLL over a validation dataset: `ds.batches(batch_size,
    shuffle=False)` yields host batches."""
    if eval_step is None:
        eval_step = make_eval_step(cfg)
    n_correct = total = nll = 0.0
    for batch in ds.batches(batch_size, shuffle=False):
        batch = {k: v for k, v in batch.items() if k != "ids"}
        c, t, n = eval_step(state.model, batch)
        n_correct += float(c)
        total += float(t)
        nll += float(n)
    total = max(total, 1.0)
    return {"accuracy": n_correct / total, "nll": nll / total, "n_tokens": int(total)}
