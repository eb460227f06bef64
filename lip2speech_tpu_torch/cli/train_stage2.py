"""Stage-2 (vocoder) GAN training CLI (JAX reference: cli/train_stage2.py;
the same flags but --fused-gen, plus --device).

An epoch loop over 0.56 s segments, one GAN step (D then G) per batch, g_ /
do_ checkpoints every --checkpoint-interval steps and at the end, validation
mel L1 over the whole validation set every --validation-interval steps with
an audio and mel snapshot, and the per-epoch rate decay. On the card the
generator's <=128-channel stages always run the trio kernel (no switch);
--device cpu runs the plain versions on the CPU.

Like the JAX CLI it trains over fitting_mesh(batch_size), data-parallel, as
train_stage1 does (parallel/multihost.run_on_mesh): every rank builds the
same global batch and steps on its rows; rank 0 prints, logs, validates and
writes the checkpoints, and the others wait for it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def _without_ids(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "ids"}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="multi_target")
    p.add_argument("--train-tsv", required=True)
    p.add_argument("--train-unt", required=True)
    p.add_argument("--valid-tsv")
    p.add_argument("--valid-unt")
    p.add_argument("--root")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--mel-aug", action="store_true",
                   help="Gaussian blur and noise on the input mels (the 'aug' config)")
    p.add_argument("--checkpoint-interval", type=int, default=10_000)
    p.add_argument("--validation-interval", type=int, default=1_000)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest g_/do_ checkpoint pair in --checkpoint-dir "
                        "(G, D, both optimizers, step, epoch, dropout generator) and continue")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return p


def _config(args):
    from lip2speech_tpu_torch.core.config import preset, with_overrides

    cfg = preset(args.preset)
    if args.batch_size:
        cfg = with_overrides(cfg, {"stage2.batch_size": args.batch_size})
    return cfg


def main(argv=None):
    """Runs the training; returns the final GanState (None when worker
    processes ran it)."""
    from lip2speech_tpu_torch.parallel.multihost import run_on_mesh

    args = _parser().parse_args(argv)
    return run_on_mesh(_train, argv, _config(args).stage2.batch_size, args.device)


def _train(argv, mesh):
    """The training on this process's rank of `mesh` (None: one device)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lip2speech_tpu_torch.data.prefetch import prefetch
    from lip2speech_tpu_torch.data.stage2 import Stage2Dataset
    from lip2speech_tpu_torch.ops.dsp import mel_spectrogram_hifigan
    from lip2speech_tpu_torch.train import checkpoint as ckpt
    from lip2speech_tpu_torch.train import stage2
    from lip2speech_tpu_torch.utils.metrics_log import MetricsLogger

    args = _parser().parse_args(argv)
    cfg = _config(args)
    bs = cfg.stage2.batch_size
    lead = mesh is None or mesh.coords() == (0, 0)
    au = cfg.audio

    ds = Stage2Dataset(args.train_tsv, args.train_unt, cfg.vocoder, root_override=args.root,
                       train=True, mel_aug=args.mel_aug)
    val_ds = None
    if args.valid_tsv:
        val_ds = Stage2Dataset(args.valid_tsv, args.valid_unt, cfg.vocoder,
                               root_override=args.root, train=False)

    state = stage2.create_gan_state(cfg, device=args.device, mesh=mesh)
    step_fn = stage2.make_gan_step(cfg, mesh)
    dev = state.device

    ckpt_dir = Path(args.checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    mlog = MetricsLogger(ckpt_dir / "logs") if lead else None
    steps = start_epoch = 0
    if args.resume:
        state, steps = ckpt.restore_stage2(ckpt_dir, state)
        start_epoch = state.epoch
        if steps and lead:
            print(f"resumed from step {steps}, epoch {start_epoch}")

    def validate():
        """Mel L1 over the whole validation set, then an audio and mel
        snapshot of the first clip, the generator in eval mode."""
        tot, nb, vb0 = 0.0, 0, None
        for vb in val_ds.batches(bs, shuffle=False):
            vb = _without_ids(vb)
            vb0 = vb if vb0 is None else vb0
            tot += float(stage2.validation_mel_l1(state.generator, vb, cfg))
            nb += 1
        val = tot / max(nb, 1)
        print(json.dumps({"step": steps, "val_mel_l1": round(val, 4), "val_batches": nb}))
        mlog.scalars(steps, val_mel_l1=val)
        if vb0 is None:
            return
        gen = state.generator
        gen.eval()
        try:
            with torch.no_grad():
                wav = gen(torch.as_tensor(vb0["code"][:1], device=dev).long(),
                          torch.as_tensor(vb0["mel"][:1], device=dev),
                          torch.as_tensor(vb0["spk_emb"][:1], device=dev))
                pred_mel = mel_spectrogram_hifigan(
                    wav, au.sample_rate, au.loss_n_fft, au.loss_hop_length, au.loss_win_length,
                    au.num_mels, au.fmin, au.loss_fmax)
        finally:
            gen.train()
        mlog.audio(steps, "val_pred", wav[0].cpu().numpy())
        mlog.mel(steps, "val_pred_spec", pred_mel[0].cpu().numpy())
        mlog.mel(steps, "val_gt_spec", np.asarray(vb0["mel"][0]), figure=True)

    t0 = time.time()
    try:
        for epoch in range(start_epoch, args.epochs):
            with prefetch(ds.batches(bs), depth=2) as batches:
                for batch in batches:
                    state, logs = step_fn(state, _without_ids(batch))
                    steps += 1
                    if steps % args.log_interval == 0 and lead:
                        print(json.dumps({
                            "epoch": epoch, "step": steps,
                            "loss_gen": round(float(logs["loss_gen"]), 3),
                            "loss_disc": round(float(logs["loss_disc"]), 3),
                            "mel_l1": round(float(logs["loss_mel"]), 4),
                            "sps": round(steps / (time.time() - t0), 2)}))
                        mlog.scalars(steps, loss_gen=logs["loss_gen"],
                                     loss_disc=logs["loss_disc"], mel_l1=logs["loss_mel"])
                    if steps % args.checkpoint_interval == 0:
                        ckpt.save_stage2(ckpt_dir, state, steps)
                    if val_ds is not None and steps % args.validation_interval == 0:
                        if lead:
                            validate()
                        if mesh is not None:
                            dist.barrier()
            state = stage2.next_epoch(state)
    finally:
        if lead:
            mlog.close()
    ckpt.save_stage2(ckpt_dir, state, steps)
    if lead:
        print(f"done: {steps} steps, {args.epochs} epochs")
    return state


if __name__ == "__main__":
    main()
