"""Tracing and timing helpers (the port's own copy of the JAX package's
utils/profiling.py, with torch.profiler in place of jax.profiler).

device_trace writes a Chrome trace (chrome://tracing, Perfetto, TensorBoard's
profiler plugin) of the host's ops and, where a card is present, its kernels;
annotate names a range in that trace, and on a card also an NVTX range;
StageTimer accumulates per-stage wall time; TokensPerSecond is a running
rate meter. The last two read the host clock only.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def device_trace(logdir: str | Path = "/tmp/lip2speech-torch-trace"):
    """Trace the enclosed work with torch.profiler (the host's ops, and the
    card's kernels when CUDA is available) and write it into logdir as
    <host>.<pid>.<ns>.pt.trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(logdir / f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range in the device trace; on a card also an NVTX range."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


class StageTimer:
    """Accumulating per-stage wall timers (the reference's time_wrapper)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 4)}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))


class TokensPerSecond:
    """Running tokens/s meter (fairseq TimeMeter wps equivalent)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.n = 0

    def update(self, n_tokens: int):
        self.n += n_tokens

    @property
    def avg(self) -> float:
        return self.n / max(time.perf_counter() - self.t0, 1e-9)
