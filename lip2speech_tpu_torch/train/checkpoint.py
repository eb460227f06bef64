"""Checkpoints of both training stages, as torch.save files (JAX reference:
train/checkpoint.py, which writes orbax directories under the same names).

  stage 1   s1_########.pt   model state_dict (parameters and BatchNorm
                             statistics), optimizer state_dict, step, and
                             the states of the two noise generators;
                             s1_00000000.pt is the best checkpoint
  stage 2   g_########       the generator's state_dict only (for serving)
            do_########      MPD and MSD state_dicts (the MSD's spectral-norm
                             u buffers included), both optimizers, step,
                             epoch and the dropout generator's state

The port draws its training noise from stateful torch.Generators
(TrainState.gen and .seed_gen, GanState.rng) where JAX folds the update
number into a key, so their states are saved, each with its device type: a
save, a restore into a fresh state and one step give what one uninterrupted
step gives. A generator's state is restored only into a generator of the
same device type (a CPU and a CUDA generator keep states of different
kinds); otherwise, and for files without them (a converted JAX run), the
state's freshly seeded generator is kept. Every file
holds tensors (saved from the CPU), numbers and containers only, and is read
back with torch.load(weights_only=True); optimizer state returns to the
device of the state it is restored into. Each file carries
"format": FORMAT, which tells it apart from a reference checkpoint.

A state spread over a mesh of ranks (TrainState.mesh, GanState.mesh) is
saved by rank 0 alone, in the single-card layout: the parameters split over
the model axis, and their optimizer moments, are gathered first (every rank
takes part), and the others wait at a barrier. Every rank restores from the
one file and keeps its part. Such a file holds rank 0's noise generators, so
a one-card resume continues them; a resume over a mesh re-seeds every
rank's generators from their seeds and the step instead.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

FORMAT = "lip2speech_tpu_torch"


def _cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save(path: str | Path, content: dict) -> Path:
    """torch.save of `content`, moved to the CPU, with the format tag. The
    file is written under a temporary name and renamed, so a run cut off
    while saving leaves no truncated checkpoint for --resume to pick."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"format": FORMAT, **_cpu(content)}, tmp)
    os.replace(tmp, path)
    return path


def is_port_checkpoint(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get("format") == FORMAT


def load(path: str | Path) -> dict:
    """A file written by `save`, on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not is_port_checkpoint(obj):
        raise ValueError(f"{path} is not a checkpoint of {FORMAT}")
    return obj


def scan_checkpoints(ckpt_dir: str | Path, prefix: str) -> Path | None:
    """The checkpoint with the highest step among `prefix`########[.pt]."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_step = None, -1
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)(\.pt)?", p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def _step_of(path: Path) -> int:
    return int(re.search(r"_(\d+)", path.name).group(1))


def generator_state(gen: torch.Generator) -> dict:
    return {"device": gen.device.type, "state": gen.get_state()}


def set_generator_state(gen: torch.Generator, saved: dict | None) -> None:
    """Set `gen` to a state saved by `generator_state` if that state is of
    gen's own device type; else leave it as it is."""
    if saved is not None and saved["device"] == gen.device.type:
        gen.set_state(saved["state"])


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.distributed


def _save_on_rank_zero(mesh, path: Path, content: dict) -> Path:
    """Rank 0 writes; every rank of a mesh waits until it has."""
    import torch.distributed as dist

    if not _distributed(mesh) or dist.get_rank() == 0:
        save(path, content)
    if _distributed(mesh):
        dist.barrier()
    return path


def reseed(gen: torch.Generator, step: int) -> None:
    """A fresh, deterministic state for a rank's generator at a resume."""
    gen.manual_seed((gen.initial_seed() * 1_000_003 + step) % 2 ** 63)


def _moments(state, optimizer_sd: dict, fn) -> dict:
    """optimizer_sd with the moments of the split parameters passed through
    fn(tensors, dims, mesh) (gather_params or split_params), in the order of
    the parameters on every rank."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    out = {**optimizer_sd, "state": dict(optimizer_sd["state"])}
    for i in sorted(out["state"]):
        if names[i] in state.sharded:
            dims = {k: state.sharded[names[i]] for k in ("exp_avg", "exp_avg_sq")}
            out["state"][i] = {**out["state"][i],
                               **fn({k: out["state"][i][k] for k in dims}, dims, state.mesh)}
    return out


def stage1_content(state) -> dict:
    """What an s1_ file holds of a TrainState, in the single-card layout
    (split parameters gathered: every rank of the state's mesh calls it)."""
    from lip2speech_tpu_torch.parallel.sharding_rules import gather_params

    model_sd, optimizer_sd = state.model.state_dict(), state.optimizer.state_dict()
    if state.sharded:
        model_sd = gather_params(model_sd, state.sharded, state.mesh)
        optimizer_sd = _moments(state, optimizer_sd, gather_params)
    return {"model": model_sd, "optimizer": optimizer_sd,
            "step": state.step, "gen": generator_state(state.gen),
            "seed_gen": generator_state(state.seed_gen)}


def save_stage1(ckpt_dir: str | Path, state, step: int) -> Path:
    return _save_on_rank_zero(state.mesh, Path(ckpt_dir) / f"s1_{step:08d}.pt",
                              stage1_content(state))


def load_stage1(path: str | Path, state):
    """Load one s1_* file into `state` (in place; returns it), each rank of
    a mesh its part. The noise generators are set where the file holds
    states of their kinds, or re-seeded over a mesh."""
    from lip2speech_tpu_torch.parallel.sharding_rules import split_params

    ck = load(path)
    model_sd, optimizer_sd = ck["model"], ck["optimizer"]
    if state.sharded:
        model_sd = split_params(model_sd, state.sharded, state.mesh)
        optimizer_sd = _moments(state, optimizer_sd, split_params)
    state.model.load_state_dict(model_sd, strict=True)
    state.optimizer.load_state_dict(optimizer_sd)
    state.step = int(ck["step"])
    if _distributed(state.mesh):
        reseed(state.gen, state.step)
        reseed(state.seed_gen, state.step)
    else:
        set_generator_state(state.gen, ck.get("gen"))
        set_generator_state(state.seed_gen, ck.get("seed_gen"))
    return state


def restore_stage1(ckpt_dir: str | Path, state):
    """Restore the newest s1_* file for --resume. Returns (state, update),
    or (state, 0) when there is nothing to resume from; the best checkpoint
    (s1_00000000) is not resumed from."""
    path = scan_checkpoints(ckpt_dir, "s1_")
    if path is None or _step_of(path) == 0:
        return state, 0
    return load_stage1(path, state), _step_of(path)


def save_stage2(ckpt_dir: str | Path, state, step: int) -> tuple[Path, Path]:
    """g_* holds the generator only; do_* the rest (the reference's split)."""
    g_path = _save_on_rank_zero(state.mesh, Path(ckpt_dir) / f"g_{step:08d}",
                                {"generator": state.generator.state_dict()})
    do_path = _save_on_rank_zero(state.mesh, Path(ckpt_dir) / f"do_{step:08d}", {
        "mpd": state.mpd.state_dict(), "msd": state.msd.state_dict(),
        "gen_opt": state.gen_opt.state_dict(), "disc_opt": state.disc_opt.state_dict(),
        "step": state.step, "epoch": state.epoch, "rng": generator_state(state.rng)})
    return g_path, do_path


def restore_stage2(ckpt_dir: str | Path, state):
    """Restore the newest g_ / do_ pair (generator, discriminators, both
    optimizers, step, epoch, and the dropout generator where the file holds
    a state of its kind). Returns (state, steps), or
    (state, 0) when there is nothing to resume from."""
    g_path = scan_checkpoints(ckpt_dir, "g_")
    do_path = scan_checkpoints(ckpt_dir, "do_")
    if g_path is None or do_path is None:
        return state, 0
    state.generator.load_state_dict(load(g_path)["generator"], strict=True)
    do = load(do_path)
    state.mpd.load_state_dict(do["mpd"], strict=True)
    state.msd.load_state_dict(do["msd"], strict=True)
    state.gen_opt.load_state_dict(do["gen_opt"])
    state.disc_opt.load_state_dict(do["disc_opt"])
    state.step, state.epoch = int(do["step"]), int(do["epoch"])
    if _distributed(state.mesh):
        reseed(state.rng, state.step)
    else:
        set_generator_state(state.rng, do.get("rng"))
    return state, _step_of(g_path)
