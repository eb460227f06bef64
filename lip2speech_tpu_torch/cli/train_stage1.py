"""Stage-1 training CLI (JAX reference: cli/train_stage1.py; the same flags,
plus --device).

A prefetched stream of accumulated micro-batches (update_freq), one
optimizer update each, checkpoints every --save-interval updates, the best
checkpoint (s1_00000000) by validation accuracy (train accuracy without a
validation set), and a final save. --device cpu runs the plain versions on
the CPU; without it the run needs a card.

Like the JAX CLI it trains over fitting_mesh(batch_size), data-parallel
(parallel/multihost.run_on_mesh): started plainly with several visible cards
it starts one worker process a card of that mesh; started by a launcher
(torchrun, or the JAX names COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID) each process is one rank of it. Every rank builds the same
global batch from the same seeded stream and trains on its rows; rank 0
prints, logs and writes the checkpoints, and the others wait for it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="multi_target")
    p.add_argument("--train-tsv", required=True)
    p.add_argument("--train-unt", required=True)
    p.add_argument("--valid-tsv")
    p.add_argument("--valid-unt")
    p.add_argument("--root")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--max-updates", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--update-freq", type=int, default=None)
    p.add_argument("--save-interval", type=int, default=1000)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--uint8-video", action="store_true",
                   help="ship video to the device as uint8 and normalise it there "
                        "(4x fewer bytes host to device)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest s1_* checkpoint in --checkpoint-dir "
                        "(model, optimizer, step, noise generators) and continue")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return p


def _config(args):
    from lip2speech_tpu_torch.core.config import preset, with_overrides

    cfg = preset(args.preset)
    overrides = {}
    if args.max_updates:
        overrides["stage1.max_updates"] = args.max_updates
    if args.batch_size:
        overrides["stage1.batch_size"] = args.batch_size
    if args.update_freq:
        overrides["stage1.update_freq"] = args.update_freq
    if overrides:
        cfg = with_overrides(cfg, overrides)
    return cfg


def accum_stream(ds, s1, pad_id: int):
    """Endless stacked accumulation batches of the dataset's seeded stream
    (every rank of a mesh draws the same ones and trains on its rows)."""
    from lip2speech_tpu_torch.train import stage1

    while True:
        micro_batches = []
        for batch in ds.batches(s1.batch_size, shuffle=True):
            micro_batches.append(batch)
            if len(micro_batches) == s1.update_freq:
                yield stage1.stack_accum(micro_batches, pad_id=pad_id, batch_size=s1.batch_size)
                micro_batches = []


def main(argv=None):
    """Runs the training; returns the final TrainState (None when worker
    processes ran it)."""
    from lip2speech_tpu_torch.parallel.multihost import run_on_mesh

    args = _parser().parse_args(argv)
    return run_on_mesh(_train, argv, _config(args).stage1.batch_size, args.device)


def _train(argv, mesh):
    """The training on this process's rank of `mesh` (None: one device)."""
    from lip2speech_tpu_torch.data.prefetch import prefetch
    from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
    from lip2speech_tpu_torch.train import checkpoint as ckpt
    from lip2speech_tpu_torch.train import stage1
    from lip2speech_tpu_torch.utils.metrics_log import MetricsLogger

    args = _parser().parse_args(argv)
    cfg = _config(args)
    s1 = cfg.stage1
    lead = mesh is None or mesh.coords() == (0, 0)
    log = print if lead else (lambda *a, **k: None)

    ds = Stage1Dataset(args.train_tsv, args.train_unt, root_override=args.root, train=True,
                       random_erase=True, time_mask=True, seed=args.seed,
                       emit_uint8=args.uint8_video)
    val_ds = None
    if args.valid_tsv:
        val_ds = Stage1Dataset(args.valid_tsv, args.valid_unt, root_override=args.root,
                               train=False, emit_uint8=args.uint8_video)

    state = stage1.create_train_state(cfg, seed=args.seed, device=args.device, mesh=mesh)
    step_fn = stage1.make_train_step(cfg, mesh)
    eval_step = stage1.make_eval_step(cfg) if val_ds is not None else None
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"device: {state.device}, params: {n_params / 1e6:.1f}M"
        + ("" if mesh is None else f", mesh: {mesh.shape}"))

    ckpt_dir = Path(args.checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    mlog = MetricsLogger(ckpt_dir / "logs") if lead else None
    best_path = ckpt_dir / "best.json"
    best_acc = -1.0
    update = 0
    if args.resume:
        state, update = ckpt.restore_stage1(ckpt_dir, state)
        if update:
            log(f"resumed from update {update}")
        if best_path.exists():
            best_acc = json.loads(best_path.read_text()).get("accuracy", -1.0)
    pad_id = cfg.model.units.pad

    def save_best(acc: float, source: str):
        """Every rank takes the same decision: the accuracy is global."""
        nonlocal best_acc
        if acc > best_acc:
            best_acc = acc
            ckpt.save_stage1(ckpt_dir, state, 0)            # s1_00000000 = best
            if lead:
                best_path.write_text(json.dumps({"accuracy": acc, "update": update,
                                                 "metric": source}))

    t0 = time.time()
    saved_at = None
    # the stream is endless, so the loop always ends by break; close() stops
    # the fill thread and frees its buffered batches
    stream = prefetch(accum_stream(ds, s1, pad_id), depth=2)
    try:
        for stacked in stream:
            if update >= s1.max_updates:
                break                      # --resume of a finished run
            state, logs = step_fn(state, stacked)
            update += 1
            if update % args.log_interval == 0 and lead:
                acc = float(logs["n_correct"]) / max(float(logs["total"]), 1)
                print(json.dumps({
                    "update": update, "loss": round(float(logs["loss"]), 3),
                    "nll": round(float(logs["nll_loss"]), 3),
                    "mel": round(float(logs["mel_loss"]), 3), "acc": round(acc, 4),
                    "ups": round(update / (time.time() - t0), 3)}))
                mlog.scalars(update, loss=logs["loss"], nll=logs["nll_loss"],
                             mel=logs["mel_loss"], acc=acc, grad_norm=logs["grad_norm"])
            if update % args.save_interval == 0:
                ckpt.save_stage1(ckpt_dir, state, update)
                saved_at = update
                if val_ds is not None:
                    # every rank evaluates the whole set (the model is whole
                    # on each), so all take the same save_best decision
                    val = stage1.evaluate(state, val_ds, s1.batch_size, cfg, eval_step=eval_step)
                    log(json.dumps({"update": update, "val_acc": round(val["accuracy"], 4),
                                    "val_nll": round(val["nll"], 4)}))
                    if lead:
                        mlog.scalars(update, val_acc=val["accuracy"], val_nll=val["nll"])
                    save_best(val["accuracy"], "valid_accuracy")
                else:
                    save_best(float(logs["n_correct"]) / max(float(logs["total"]), 1),
                              "train_accuracy")
            if update >= s1.max_updates:
                break
    finally:
        stream.close()
        if lead:
            mlog.close()
    if saved_at != update:
        ckpt.save_stage1(ckpt_dir, state, update)
    log(f"done: {update} updates in {time.time() - t0:.1f}s")
    return state


if __name__ == "__main__":
    main()
