"""Helpers the per-layer readers share (benchmark/metrics/<name>.py)."""

from __future__ import annotations

import sys

from benchmark import work
from benchmark.trace import View


def roofline(view: View, key: str, pattern: str, work_fn) -> float | None:
    """100 x (the bound time of the window's launches of `key`) / (the device
    time of the kernels whose name matches `pattern`). Left out where the
    launches recorded differ from the port's own count (a kernel fused away
    or renamed), or where nothing ran."""
    records, count = view.work.get(key), view.launches.get(key)
    if records is None:
        return None
    if count != len(records):
        print(f"metric {key}: {len(records)} launches recorded, the port counted {count}; "
              "left out", file=sys.stderr)
        return None
    if not records:
        return None
    device_s = view.kernel_s(pattern)
    if device_s <= 0.0:
        print(f"metric {key}: {len(records)} launches but no device kernel matches "
              f"{pattern!r}; left out", file=sys.stderr)
        return None
    bound = sum(work.bound_s(n_bytes, flops, dtype) for n_bytes, flops, dtype in map(work_fn, records))
    return 100.0 * bound / device_s


def idle_share(view: View) -> float | None:
    if view.window_s <= 0.0 or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def mfu(view: View) -> float | None:
    if view.window_s <= 0.0 or view.model_flops <= 0.0:
        return None
    return 100.0 * view.model_flops / view.window_s / work.PEAK_FLOPS[view.dtype]


def per_speech_s(view: View, range_name: str) -> float | None:
    """Device ms inside a range per second of speech computed."""
    s = view.range_device_s(range_name)
    if s is None or view.speech_s <= 0.0:
        return None
    return 1e3 * s / view.speech_s
