"""Capacity probe: grow a synthetic clip until synthesis runs out of device
memory or reaches the cap (JAX reference: cli/find_max_duration.py).

Rebuild of reference find_max_duration.py:10-42, which probes the GPU
decoder's duration limit with a constant-frame video: each probe runs the
random-weight pipeline (Lip2SpeechPipeline.initialize_random, f32) on a B1
clip of int(seconds * 25) all-zero 88 x 88 frames, once to warm up and once
timed (after a device synchronize, to the waveform on the host), and
reports the latency and the real-time factor.

A probe ends the list only on torch.cuda.OutOfMemoryError, the capacity
limit the tool measures. Any other error raises: the JAX tool catches every
Exception (find_max_duration.py:46-48), which would also hide a failing
kernel.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

FPS = 25
MOUTH = 88


def probe(pipe, seconds: float) -> tuple[dict, np.ndarray]:
    """One probe of `seconds` on the pipeline's device: (its result line,
    the timed call's waveform (int(seconds * 25) * 640,) on the host)."""
    dev = pipe.device
    frames = int(seconds * FPS)
    video = torch.zeros((1, frames, MOUTH, MOUTH, 1), device=dev)
    mask = torch.ones((1, frames), dtype=torch.bool, device=dev)
    spk = torch.zeros((1, 256), device=dev)
    pipe.forward(video, mask, spk)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    wav = pipe.forward(video, mask, spk)[0].cpu().numpy()[0]
    dt = time.perf_counter() - t0
    return {"seconds": seconds, "frames": frames, "ok": True,
            "latency_ms": round(dt * 1000, 1), "rtf": round(seconds / dt, 1)}, wav


def probe_durations(pipe, max_seconds: float = 24.0, step_seconds: float = 4.0) -> dict:
    """Probes at step_seconds, 2 step_seconds, ... up to max_seconds, until
    the first that runs out of device memory."""
    results = []
    secs = step_seconds
    while secs <= max_seconds + 1e-6:
        try:
            results.append(probe(pipe, secs)[0])
        except torch.cuda.OutOfMemoryError as e:
            results.append({"seconds": secs, "ok": False, "error": str(e)[:200]})
            torch.cuda.empty_cache()
            break
        secs += step_seconds
    ok = [r for r in results if r.get("ok")]
    return {"max_ok_seconds": ok[-1]["seconds"] if ok else 0, "probes": results}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="multi_target")
    p.add_argument("--max-seconds", type=float, default=24.0)
    p.add_argument("--step-seconds", type=float, default=4.0)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)

    from lip2speech_tpu_torch.core.config import preset
    from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline

    pipe = Lip2SpeechPipeline.initialize_random(preset(args.preset), device=args.device)
    out = probe_durations(pipe, args.max_seconds, args.step_seconds)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
