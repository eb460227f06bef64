"""Process-group set-up (JAX reference: parallel/multihost.py).

A "process" of the JAX package is one host driving all its chips; in the
port it is one rank of torch.distributed driving one card (or the CPU), so
process_index / process_count are the rank and the world size. `initialize`
joins the group from its arguments or the launcher's environment: torchrun's
RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or the JAX
package's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID. NCCL on the
cards, gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os

import torch


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def launcher_environment() -> bool:
    """True when a launcher set the environment of a rank (torchrun's
    RANK / WORLD_SIZE, or the JAX names)."""
    return "COORDINATOR_ADDRESS" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, init_method: str | None = None,
               backend: str | None = None, device: str | torch.device | None = None,
               timeout: float | None = None) -> dict:
    """init_process_group from the arguments or the environment.

    The rendezvous: init_method (e.g. "file:///tmp/store", "tcp://host:port")
    when given, else tcp://coordinator_address (argument or
    COORDINATOR_ADDRESS, with NUM_PROCESSES and PROCESS_ID), else torchrun's
    env:// (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), else a group of one
    process. backend: NCCL when `device` (default: the card of LOCAL_RANK,
    or the CPU without a card) is a card, else gloo. timeout: seconds a
    collective may wait (torch's default when None). Returns the JAX
    function's dict."""
    dist = _dist()
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr or init_method:
        world = int(num_processes or env.get("NUM_PROCESSES", env.get("WORLD_SIZE", 1)))
        rank = int(process_id if process_id is not None
                   else env.get("PROCESS_ID", env.get("RANK", 0)))
        init_method = init_method or f"tcp://{addr}"
    elif "MASTER_ADDR" in env:
        world, rank, init_method = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    else:
        world, rank, init_method = 1, 0, None
    if device is None:
        device = (torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                **kw)
    return {"process_index": process_index(), "process_count": process_count(),
            "local_devices": 1, "global_devices": process_count()}


def process_shard(n_items: int) -> slice:
    """This rank's contiguous shard of a dataset (per-process data loading —
    the DistributedSampler equivalent)."""
    per = -(-n_items // process_count())
    start = process_index() * per
    return slice(start, min(start + per, n_items))


def host_local_batch_size(global_batch: int) -> int:
    if global_batch % process_count():
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{process_count()} processes")
    return global_batch // process_count()


def run_on_mesh(fn, argv, batch_size: int, device: str | None = None):
    """fn(argv, mesh) over fitting_mesh(batch_size), as the JAX training CLIs
    train over all local devices:

      * inside a process group (joined already, or a launcher's environment,
        which it joins and leaves): on the group's ranks, which the mesh must
        take every one of (a world the batch does not divide raises);
      * else over the local cards (or `device` alone, when given): one worker
        process a card of the fitting mesh, joined in a group over a
        FileStore in a temporary directory, each running fn; with a data
        axis of 1, fn(argv, None) in this process, the single-card path.

    Returns fn's result in this process, or None when workers ran it. A
    worker that raises fails the call."""
    import tempfile

    import torch.multiprocessing as mp

    from lip2speech_tpu_torch.parallel.mesh import fitting_data, fitting_mesh

    dist = _dist()
    joined = False
    if not dist.is_initialized() and launcher_environment():
        initialize(device=device)
        joined = True
    if dist.is_initialized():
        try:
            mesh = fitting_mesh(batch_size)
            if mesh.size != dist.get_world_size():
                raise ValueError(f"a batch of {batch_size} fits a data axis of {mesh.size}, "
                                 f"not the {dist.get_world_size()} ranks")
            return fn(argv, mesh)
        finally:
            if joined:
                dist.destroy_process_group()
    cards = torch.cuda.device_count() if device is None and torch.cuda.is_available() else 1
    data = fitting_data(batch_size, cards)
    if data == 1:
        return fn(argv, None)
    with tempfile.TemporaryDirectory(prefix="l2s_group_") as store:
        mp.start_processes(_mesh_worker, args=(data, f"{store}/store", fn, argv, batch_size),
                           nprocs=data, join=True, start_method="spawn")
    return None


def _mesh_worker(rank: int, world: int, store: str, fn, argv, batch_size: int) -> None:
    initialize(init_method=f"file://{store}", num_processes=world, process_id=rank,
               device=torch.device("cuda", rank))
    try:
        run_on_mesh(fn, argv, batch_size)
    finally:
        _dist().destroy_process_group()
