#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (an orbax s1_*, g_* or do_*
directory, or the variables of an ASR model, an LM or the GE2E speaker
encoder) into a checkpoint file of the PyTorch port.

    python scripts/orbax_to_torch.py --input ckpt/s1_00010000 \
        --output torch_ckpt/s1_00010000.pt [--preset multi_target]
    python scripts/orbax_to_torch.py --input ckpt/g_00100000 --output torch_ckpt/g_00100000
    python scripts/orbax_to_torch.py --input ckpt/do_00100000 \
        --output torch_ckpt/do_00100000 [--preset multi_target]
    python scripts/orbax_to_torch.py --input asr_vars --output asr.pt

The one tool that imports both packages: the JAX package restores the tree
(lip2speech_tpu.train.checkpoint.load_pytree) and the port's
convert/from_jax.py moves it into the port's names and layouts.

  s1_*  -> a full port s1_ file that lip2speech_tpu_torch.train.checkpoint
           resumes from (restore_stage1): parameters and BatchNorm
           statistics, the step, and AdamW's moments (optax's mu and nu as
           exp_avg and exp_avg_sq, its count as each parameter's step). The
           port's noise generators have no JAX counterpart, so the file
           holds none: a resumed run keeps the generators it seeded itself,
           on whatever device it runs.
  g_*   -> a port g_ file holding the generator ({"generator": state_dict}),
           which `vocode --checkpoint` reads.
  do_*  -> a port do_ file: MPD and MSD state_dicts (the MSD's spectral u
           vectors as its buffers), both AdamW states as torch AdamW
           state_dicts (mu, nu and count as exp_avg, exp_avg_sq and each
           parameter's step; the generator's parameters in the order of the
           --preset's vocoder), step and epoch. With the g_ file beside it,
           `train_stage2 --resume` continues the JAX run (its dropout
           generator freshly seeded).
  asr   -> the {"encoder", "decoder"} variables of an AVHubertSeq2Seq or a
           RavenASR (what the JAX infer_asr --checkpoint reads) -> a port
           file {"model": state_dict}, which the port's infer_asr
           --checkpoint reads.
  lm    -> the {"params"} variables of a TransformerLM -> {"model":
           state_dict}, for infer_asr --lm-checkpoint.
  speaker -> the GE2E encoder params ({"lstm_k", "linear"}) -> {"speaker":
           state_dict}, which `create_dataset init --speaker-encoder` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lip2speech_tpu.train.checkpoint import load_pytree  # noqa: E402
from lip2speech_tpu_torch.convert import from_jax  # noqa: E402
from lip2speech_tpu_torch.core.config import preset  # noqa: E402
from lip2speech_tpu_torch.train import checkpoint, stage1, stage2  # noqa: E402


def _adam_state(tree):
    """The optax ScaleByAdam state ({"count", "mu", "nu"}) inside an
    optimizer state tree, or None."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _dense(tree):
    """Drop the leaves optax masks out (a frozen frontend's None moments)."""
    if isinstance(tree, dict):
        kept = {k: _dense(v) for k, v in tree.items() if v is not None}
        return {k: v for k, v in kept.items() if not (isinstance(v, dict) and not v)}
    return tree


def _load_moments(optimizer, named_params, opt_tree) -> None:
    """Set the AdamW state of each (name, parameter) from the optax Adam
    state in opt_tree (mu, nu by the names of the JAX tree, count as the
    step); nothing when it has taken no step."""
    adam = _adam_state(opt_tree)
    if adam is None or int(np.asarray(adam["count"])) == 0:
        return
    mu = from_jax.jax_tree_to_state_dict(_dense(adam["mu"]))
    nu = from_jax.jax_tree_to_state_dict(_dense(adam["nu"]))
    count = float(np.asarray(adam["count"]))
    for name, p in named_params:
        optimizer.state[p] = {"step": torch.tensor(count), "exp_avg": mu[name].clone(),
                              "exp_avg_sq": nu[name].clone()}


def convert_stage1(tree: dict, cfg) -> dict:
    """A restored JAX s1_ tree -> the content of a port s1_ file for the
    model of `cfg`, without noise generator states."""
    sd = from_jax.stage1_state_dict({"params": tree["params"],
                                     "batch_stats": tree.get("batch_stats", {})})
    state = stage1.create_train_state(cfg, device="cpu", state_dict=sd)
    state.step = int(np.asarray(tree["step"]))
    _load_moments(state.optimizer, [(n, p) for n, p in state.model.named_parameters()
                                    if p.requires_grad], tree.get("opt_state"))
    content = checkpoint.stage1_content(state)
    del content["gen"], content["seed_gen"]
    return content


def convert_stage2_do(tree: dict, cfg) -> dict:
    """A restored JAX do_ tree -> the content of a port do_ file, without
    the dropout generator's state; `cfg` gives the generator's parameters
    (the order of gen_opt's state)."""
    state = stage2.create_gan_state(cfg, device="cpu")
    state.mpd.load_state_dict(from_jax.discriminator_state_dict(tree["mpd"]), strict=True)
    state.msd.load_state_dict(from_jax.discriminator_state_dict(
        tree["msd"], tree.get("msd_spectral")), strict=True)
    _load_moments(state.gen_opt, state.generator.named_parameters(), tree["gen_opt"])
    _load_moments(state.disc_opt,
                  [(f"{pre}.{n}", p) for pre, m in (("mpd", state.mpd), ("msd", state.msd))
                   for n, p in m.named_parameters()], tree["disc_opt"])
    return {"mpd": state.mpd.state_dict(), "msd": state.msd.state_dict(),
            "gen_opt": state.gen_opt.state_dict(), "disc_opt": state.disc_opt.state_dict(),
            "step": int(np.asarray(tree["step"])), "epoch": int(np.asarray(tree["epoch"]))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True,
                   help="orbax s1_*, g_* or do_* directory, or ASR / LM / speaker variables")
    p.add_argument("--output", required=True, help="port checkpoint file to write")
    p.add_argument("--preset", default="multi_target",
                   help="s1_ and do_ only: the model's preset")
    args = p.parse_args(argv)

    tree = load_pytree(args.input)
    if {"encoder", "decoder"} <= set(tree):
        content = {"model": from_jax.asr_state_dict(tree)}
        kind = "asr"
    elif "params" in tree and "step" not in tree and "embed" in tree["params"]:
        content = {"model": from_jax.lm_state_dict(tree)}
        kind = "lm"
    elif "params" in tree:
        content = convert_stage1(tree, preset(args.preset))
        kind = "stage1"
    elif "generator" in tree:
        content = {"generator": from_jax.vocoder_state_dict(tree["generator"])}
        kind = "vocoder_g"
    elif {"mpd", "msd", "gen_opt", "disc_opt"} <= set(tree):
        content = convert_stage2_do(tree, preset(args.preset))
        kind = "vocoder_do"
    elif "linear" in tree and any(k.startswith("lstm_") for k in tree):
        content = {"speaker": from_jax.speaker_state_dict(tree)}
        kind = "speaker"
    else:
        raise SystemExit(f"{args.input}: not an s1_, g_, do_, ASR, LM or speaker checkpoint "
                         f"(keys {sorted(tree)})")
    path = checkpoint.save(args.output, content)
    print(json.dumps({"kind": kind, "output": str(path)}))


if __name__ == "__main__":
    main()
