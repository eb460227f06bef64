"""The stage-1 training step as `cli/train_stage1.py` runs it: the state of
`train.stage1.create_train_state` (the seed's weights, AdamW, the noise
generators seeded with the seed), the step of `make_train_step`, batches of
host arrays shaped (update_freq, batch_size, ...) as the CLI's loader hands
them (float32 normalised video, masks, speaker embeddings, unit tokens with
EOS, mel targets; clips padded to the mix's length), so the copy to the card
is inside the step.

Set-up makes `distinct_updates` batches from the seed, every row different,
and drives the state through the first `checked` updates on the first of
them: these warm up every shape, and are the updates held against the plain
reference. They run with the state's update count set to the mix's
`checked_from_update` (the end of the warm-up), so that each moves the
parameters at the full rate; the rate changes no work. The window then cycles the batches for `seconds`, one
synchronised update after another. Once the state is freed the reference
runs the same updates from the same weights, data, noise and count:

  first_loss_gap  |loss - loss_ref| / |loss_ref| of the first update
  loss_gap   the largest of that over the updates (at the full rate the
             later updates carry round-off forward: each sign that Adam's
             step takes from a gradient near zero moves a weight by 2e-3)
  grad_gap   the worst leaf's | |g| - |g_ref| | / max(|g_ref|, the median
             leaf's |g_ref|), g the first update's gradient as AdamW got it
             (its first moment after one update over 1 - beta1)
  delta_gap  the same of each leaf's change over the checked updates, for
             the leaves whose reference gradient is at least 1e-3 of the
             median leaf's (the others move by round-off alone)
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import harness, trace, traffic, work


def make_batches(cfg, tr: dict, seed: int, dev) -> tuple[list[dict], list[int]]:
    """`distinct_updates` host batches and the lengths of their rows."""
    import torch

    accum, bsz, t = cfg.stage1.update_freq, tr["batch_size"], tr["pad_to"]
    k = tr["distinct_updates"]
    rng = np.random.default_rng([seed, 2])
    lens = traffic.lengths(tr["lengths"], k * accum * bsz, rng).reshape(k, accum, bsz)
    u = cfg.model.units
    gen = torch.Generator(device=dev).manual_seed(harness.sub_seed(seed, 2))
    size = cfg.video.mouth_size
    batches = []
    for i in range(k):
        mask = np.arange(t)[None, None, :] < lens[i][:, :, None]
        m = torch.as_tensor(mask, device=dev)
        pix = torch.randint(0, 256, (accum, bsz, t, size, size, 1), generator=gen, device=dev,
                            dtype=torch.uint8)
        video = torch.where(m[..., None, None, None], (pix.float() / 255.0 - 0.421) / 0.165, 0.0)
        mel = torch.randn((accum, bsz, 4 * t, cfg.model.mel_dim), generator=gen, device=dev)
        mel = torch.where(torch.repeat_interleave(m, 4, dim=2)[..., None], mel, 0.0)
        units = rng.integers(0, u.num_units, (accum, bsz, 2 * t)) + u.num_special
        tokens = np.full((accum, bsz, 2 * t + 1), u.pad, np.int32)
        for a in range(accum):
            for b in range(bsz):
                n = 2 * int(lens[i, a, b])
                tokens[a, b, :n] = units[a, b, :n]
                tokens[a, b, n] = u.eos
        spk = traffic.unit_speaker(rng, accum * bsz).reshape(accum, bsz, -1)
        batches.append({"video": video.cpu().numpy(), "frames_mask": mask, "spk_emb": spk,
                        "unit_tokens": tokens, "mel": mel.cpu().numpy()})
        del pix, video, mel
    return batches, [int(n) for n in lens.reshape(-1)]


def run(rc) -> dict:
    import torch
    from lip2speech_tpu_torch.train import stage1

    conf, tr = rc.cell.config, rc.cell.traffic
    dev = torch.device(rc.device)
    phases = {"imports": time.perf_counter() - rc.t_start}
    harness.set_precision(conf)
    cfg = harness.port_config(conf, {"stage1.update_freq": conf["update_freq"],
                                     "stage1.batch_size": tr["batch_size"],
                                     "stage1.bf16_compute": (rc.dtype or conf["dtype"]) == "bfloat16",
                                     **rc.overrides})
    sd, _ = harness.make_weights(cfg, harness.sub_seed(rc.seed, 1), dev, vocoder=False)
    state = stage1.create_train_state(cfg, seed=rc.seed, device=dev, state_dict=sd)
    del sd
    step = stage1.make_train_step(cfg)
    for hook in rc.hooks.get("train_step", ()):
        step = hook(step)
    phases["weights_and_state"] = time.perf_counter() - rc.t_start
    batches, lens = make_batches(cfg, tr, rc.seed, dev)
    phases["batches"] = time.perf_counter() - rc.t_start
    accum_rows = [lens[i * len(lens) // len(batches): (i + 1) * len(lens) // len(batches)]
                  for i in range(len(batches))]

    named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in named}
    b1 = cfg.stage1.adam_b1
    losses, grad_norms = [], {}
    state.step = tr["checked_from_update"]
    for i in range(tr["checked"]):
        state, logs = step(state, batches[i])
        losses.append(float(logs["loss"]))
        if i == 0:
            grad_norms = {n: float(state.optimizer.state[p]["exp_avg"].norm()) / (1.0 - b1)
                          for n, p in named if p in state.optimizer.state}
    delta_norms = {n: float((p.detach() - p0[n].to(dev)).norm()) for n, p in named}
    del p0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    phases["checked_updates"] = time.perf_counter() - rc.t_start

    window = None
    if rc.trace:
        from torch.autograd.profiler import record_function

        recorder = trace.Recorder(harness.kernels_to_record(rc.cell))
        recorder.install()
        window = trace.Window(recorder)
    t_first = time.perf_counter()
    setup_s = t_first - rc.t_start
    done, i, traced = 0, tr["checked"], []
    first, last = tr["trace_from_update"], tr["trace_from_update"] + tr["trace_updates"]
    while True:
        if done and time.perf_counter() - t_first >= rc.seconds:
            break
        if window is not None and done == first:
            window.start()
        if window is not None and first <= done < last:
            with record_function(trace.UPDATE):
                state, _ = step(state, batches[i % len(batches)])
            traced.append(i % len(batches))
        else:
            state, _ = step(state, batches[i % len(batches)])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        done, i = done + 1, i + 1
        if window is not None and done == last:
            window.stop()
    t_last = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {"attempted": done, "failed": 0, "setup_s": setup_s, "memory_peak_bytes": int(peak),
           "e2e": {"train_step_ms": 1e3 * (t_last - t_first) / done},
           "counts": {"updates_in_window": done, "setup_phases_s": phases}}
    if window is not None:
        recorder.uninstall()
        if len(traced) == tr["trace_updates"]:
            view = window.view(rc.dtype or conf["dtype"])
            view.updates = len(traced)
            view.model_flops = sum(work.train_row_flops(conf["arch"], n)
                                   for b in traced for n in accum_rows[b])
            out["view"] = view

    del state, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"] = _compare(rc, cfg, conf, tr, batches[: tr["checked"]], losses, grad_norms,
                              delta_norms, dev)
    return out


def _gap(prog: dict, ref: dict, names) -> float:
    scale = float(np.median([ref[n] for n in ref]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], scale) for n in names)


def _compare(rc, cfg, conf, tr, batches, losses, grad_norms, delta_norms, dev) -> dict:
    from benchmark.reference import train as ref_train

    harness.plain_precision()
    sd, _ = harness.make_weights(cfg, harness.sub_seed(rc.seed, 1), dev, vocoder=False)
    ref = ref_train.run_steps({n: t.float() for n, t in sd.items()},
                              {**conf["arch"], "pad": cfg.model.units.pad}, conf["optimizer"],
                              batches, rc.seed, dev, start=tr["checked_from_update"])
    g_ref, d_ref = ref["grad_norms"], ref["delta_norms"]
    median_g = float(np.median(list(g_ref.values())))
    moved = [n for n in d_ref if g_ref[n] >= 1e-3 * median_g]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    return {"first_loss_gap": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "loss_gap": loss_gap,
            "grad_gap": _gap({n: grad_norms.get(n, 0.0) for n in g_ref}, g_ref, list(g_ref)),
            "delta_gap": _gap(delta_norms, d_ref, moved),
            "losses": losses, "losses_ref": ref["losses"], "leaves_left_out": len(d_ref) - len(moved)}
