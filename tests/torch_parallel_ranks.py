"""Ranks of torch.distributed on the CPU for the port's parallel tests.

`spawn(fn, world, tmp_path, *args)` starts `world` processes (the spawn
context, one intra-op thread each), joins them in a gloo group over a
FileStore in tmp_path with a short collective timeout, runs
fn(rank, world, tmp_path, *args) in each and returns what each rank
returned, in rank order. A rank that raises fails the call
(torch.multiprocessing ends the others and raises). The rank functions live
in this module, which imports torch and the port only, so a rank starts
without JAX; `run_all` runs several of them in one group, one after the
other, to pay for the processes once.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import torch

TIMEOUT_S = 120.0


def spawn(fn, world: int, tmp_path: Path, *args, launcher: bool = False) -> list:
    """launcher=True: the ranks get torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) instead of a group,
    and fn joins one itself. As under torchrun, the rendezvous store is the
    launcher's: a TCPStore this process opens on a port the kernel picks
    (port 0) and holds while the ranks run, and the ranks reach it as
    clients (TORCHELASTIC_USE_AGENT_STORE), so no other process can take
    the port between its choice and the ranks' rendezvous."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    tmp_path.mkdir(parents=True, exist_ok=True)
    store = None
    if launcher:
        store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    port = None if store is None else store.port
    try:
        mp.start_processes(_rank_main, args=(world, str(tmp_path), fn, args, port),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        del store
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, tmp: str, fn, args, port) -> None:
    import torch.distributed as dist

    from lip2speech_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    if port is None:
        multihost.initialize(init_method=f"file://{tmp}/store", num_processes=world,
                             process_id=rank, device="cpu", timeout=TIMEOUT_S)
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          TORCHELASTIC_USE_AGENT_STORE="True", TORCHELASTIC_RESTART_COUNT="0")
    try:
        result = fn(rank, world, Path(tmp), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_all(rank, world, tmp, jobs):
    """[fn(rank, world, tmp / name, *args) for name, fn, args in jobs]."""
    return {name: fn(rank, world, tmp / name, *args) for name, fn, args in jobs}


# ------------------------------------------------------------------- stage 1

def stage1_steps(rank, world, tmp, cfg, state_dict, batches, data: int, model: int):
    """Train steps of a (data, model) mesh from state_dict on `batches`
    (global batches, every rank the same). Returns the logs of each step,
    the final state in the single-card layout (every rank gathers; rank 0's
    is read), the heads of the rank's first attention layer, the rows of the
    first micro-batch it trained on, and whether the state written by
    save_stage1 (gathered, rank 0) and read back by load_stage1 (split) into
    a fresh state equals the trained one on this rank."""
    from lip2speech_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from lip2speech_tpu_torch.train import checkpoint, stage1

    mesh = make_mesh(data=data, model=model)
    state = stage1.create_train_state(cfg, device="cpu", state_dict=state_dict, mesh=mesh)
    step = stage1.make_train_step(cfg, mesh)
    logs = []
    for batch in batches:
        state, lg = step(state, batch)
        logs.append({k: float(v) for k, v in lg.items()})
    content = checkpoint.stage1_content(state)
    path = checkpoint.save_stage1(tmp, state, state.step)
    fresh = checkpoint.load_stage1(path, stage1.create_train_state(
        cfg, device="cpu", state_dict=state_dict, mesh=mesh))
    same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                   state.model.state_dict().values()))
    for p, q in zip(stage1.trained_parameters(fresh.model), stage1.trained_parameters(state.model)):
        a, b = fresh.optimizer.state[p], state.optimizer.state[q]
        same &= all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    torch.distributed.barrier()        # every rank has read the file back
    if rank == 0:
        path.unlink()                  # the run keeps the result, not the file
    return {"logs": logs, "model": content["model"], "restored_equal": bool(same),
            "heads": state.model.conformer.layers_0.self_attn.pos_bias_u.shape[0],
            "split": sorted(state.sharded),
            "rows": shard_batch(mesh, batches[0], axis=1)["spk_emb"][0]}


def tp_forward(rank, world, tmp, kwargs, state_dict, x, mask, model: int):
    """The conformer encoder's eval-mode forward over a model axis."""
    from lip2speech_tpu_torch.models.conformer import ConformerEncoder
    from lip2speech_tpu_torch.parallel.mesh import make_mesh
    from lip2speech_tpu_torch.parallel.sharding_rules import shard_params

    enc = ConformerEncoder(**kwargs)
    enc.load_state_dict(state_dict, strict=True)
    dims = shard_params(enc, make_mesh(data=world // model, model=model))
    enc.eval()
    with torch.no_grad():
        out = enc(torch.as_tensor(x), torch.as_tensor(mask))
    return {"out": out.numpy(), "split": dims,
            "shapes": {k: tuple(v.shape) for k, v in enc.state_dict().items()}}


# ------------------------------------------------------------------- stage 2

def gan_steps(rank, world, tmp, cfg, state_dicts, batches):
    """GAN steps of a data-parallel mesh from state_dicts on `batches`
    (global batches), the generator's dropout off (code_dropout 0, as the
    single-process parity test), next_epoch after the first. Returns the
    logs, the first step's first moments of both optimizers by name, and the
    final state dicts."""
    from lip2speech_tpu_torch.parallel.mesh import make_mesh
    from lip2speech_tpu_torch.train import stage2

    mesh = make_mesh(data=world)
    state = stage2.create_gan_state(cfg, device="cpu", state_dicts=state_dicts, mesh=mesh)
    state.generator.code_dropout = 0.0
    step = stage2.make_gan_step(cfg, mesh)
    logs = []
    for i, batch in enumerate(batches):
        state, lg = step(state, batch)
        logs.append({k: float(v) for k, v in lg.items()})
        if i == 0:
            first = {n: state.gen_opt.state[p]["exp_avg"].clone()
                     for n, p in state.generator.named_parameters()}
            for pre, m in (("mpd", state.mpd), ("msd", state.msd)):
                first.update({f"{pre}.{n}": state.disc_opt.state[p]["exp_avg"].clone()
                              for n, p in m.named_parameters()})
            state = stage2.next_epoch(state)
    return {"logs": logs, "first_moments": first,
            "state": {k: getattr(state, k).state_dict() for k in ("generator", "mpd", "msd")}}


# --------------------------------------------------------------------- CLI

def recording_steps(record: list):
    """Wraps train.stage1.make_train_step so that each step first records,
    of every update, the rows its rank trains on (the global batch without a
    mesh): spk_emb and video of each micro-batch. Returns the undo."""
    from lip2speech_tpu_torch.parallel.mesh import shard_batch
    from lip2speech_tpu_torch.train import stage1

    real = stage1.make_train_step

    def make(cfg, mesh=None):
        step = real(cfg, mesh)

        def recorded(state, batch):
            rows = batch if mesh is None else shard_batch(mesh, batch, axis=1)
            record.append({k: rows[k].copy() for k in ("spk_emb", "video")})
            return step(state, batch)

        return recorded

    stage1.make_train_step = make
    return lambda: setattr(stage1, "make_train_step", real)


def cli_train_stage1(rank, world, tmp, argv):
    """train_stage1's main under a launcher's environment, as torchrun
    would start it (it joins the group itself); returns the step, the mesh's
    shape and the rows this rank trained on, update by update."""
    from lip2speech_tpu_torch.cli import train_stage1

    record: list = []
    undo = recording_steps(record)
    try:
        state = train_stage1.main(argv)
    finally:
        undo()
    return {"step": state.step, "mesh": dict(state.mesh.shape), "rows": record}


# ----------------------------------------------------------------- failures

def unfitting_world(rank, world, tmp, batch_size):
    """run_on_mesh in a group whose ranks the batch cannot all take."""
    from lip2speech_tpu_torch.parallel.multihost import run_on_mesh

    return run_on_mesh(lambda argv, mesh: mesh.shape, [], batch_size)


def stalled_collective(rank, world, tmp, seconds):
    """Rank 0 all-reduces on a group with a `seconds` timeout that rank 1
    never joins the collective of."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group(list(range(world)), timeout=datetime.timedelta(seconds=seconds))
    if rank == 0:
        dist.all_reduce(torch.ones(1), group=group)
    return rank
