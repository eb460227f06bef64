"""The traced run: a torch.profiler window (host ops and the card's kernels,
copies and memsets, CUPTI) over a steady slice of the measured work, the
benchmark's own ranges around the calls into each layer, the work of every
hand-written kernel launched in it, and the reduction of all of it to what
the per-layer readers read.

Device time is taken from the device's own events: busy is the union of
their intervals inside the window, a range's device time the kernels that
ran inside the device span of that range (kineto's gpu_user_annotation), or
between the marker kernels a driver launched where the range's host thread
is not the profiled one.
"""

from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass, field

STAGE1, VOCODER, CALL, UPDATE = "bench.stage1", "bench.vocoder", "bench.device_call", "bench.update"


@dataclass
class Span:
    name: str
    start: float        # microseconds on the profiler's clock
    end: float


@dataclass
class View:
    """What a per-layer reader reads. Lists hold only what happened inside
    the profiled window."""
    window_s: float
    device: list[Span]                  # kernels, copies, memsets
    host: list[Span]                    # host ops and ranges (not async)
    gpu_ranges: dict[str, list[Span]]   # device spans of the user ranges
    work: dict[str, list] = field(default_factory=dict)       # kernel -> launch records
    launches: dict[str, int] = field(default_factory=dict)    # kernel -> the wrapper's count
    calls: list = field(default_factory=list)                 # serving: [(lengths, bucket, rows)]
    updates: int = 0                                          # training: updates profiled
    model_flops: float = 0.0
    speech_s: float = 0.0
    dtype: str = "float32"
    host_marks: list = field(default_factory=list)   # the benchmark's host spans, window clock
    markers: tuple | None = None    # (marker kernel pattern, names of the segments they open)

    @property
    def busy_s(self) -> float:
        return _union_us(self.device, 0.0, self.window_s * 1e6) / 1e6

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s.end - s.start for s in self.device if rx.search(s.name)) / 1e6

    def range_device_s(self, name: str) -> float | None:
        """Seconds of device work inside the range `name`: kernels inside
        its device spans, or, where the device was marked, between the
        marker that opens a segment so named and the next. None where the
        trace holds no such range."""
        spans = self.gpu_ranges.get(name)
        if spans:
            spans = sorted(spans, key=lambda s: s.start)
            total, i = 0.0, 0
            for d in sorted(self.device, key=lambda s: s.start):
                mid = 0.5 * (d.start + d.end)
                while i < len(spans) and spans[i].end < mid:
                    i += 1
                if i < len(spans) and spans[i].start <= mid:
                    total += d.end - d.start
            return total / 1e6
        if self.markers is not None and name in self.markers[1]:
            return self._marked_s(name)
        return None

    def _marked_s(self, name: str) -> float | None:
        pattern, names = self.markers
        rx = re.compile(pattern)
        total, seen, current = 0.0, 0, None
        for d in sorted(self.device, key=lambda s: s.start):
            if rx.search(d.name):
                current = names[seen % len(names)]
                seen += 1
            elif current == name:
                total += d.end - d.start
        if seen == 0 or seen % len(names):
            return None
        return total / 1e6


def _union_us(spans, lo: float, hi: float) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s in sorted(spans, key=lambda s: s.start):
        a, b = max(s.start, lo), min(s.end, hi)
        if b <= a:
            continue
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    gaps, t = [], lo
    for s in sorted(spans, key=lambda s: s.start):
        if s.start > t:
            gaps.append((t, min(s.start, hi)))
        t = max(t, s.end)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [g for g in gaps if g[1] > g[0]]


def breakdown(view: View, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by what the host was doing at their middle: the benchmark's own
    range (a range of the profiled thread, or a device call of the serving
    driver's; outside them the batcher waits and collects) and the host op
    of the profiled thread or the CUDA runtime call then running."""
    by_name: dict[str, float] = {}
    for s in view.device:
        by_name[s.name] = by_name.get(s.name, 0.0) + (s.end - s.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(_gaps(view.device, 0.0, view.window_s * 1e6), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner, outer = None, None
        for h in list(view.host) + list(view.host_marks):
            if h.start <= mid <= h.end:
                if h.name.startswith("bench.") and (outer is None or h.start >= outer.start):
                    outer = h
                elif not h.name.startswith("bench.") and (inner is None or h.start >= inner.start):
                    inner = h
        if outer is None and view.host_marks:
            outer = Span("between device calls", a, b)
        label = " > ".join(x.name for x in (outer, inner) if x is not None) or "no host op"
        named.append([label[:160], (b - a) / 1e6])
    return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": named}


class Recorder:
    """The launches of the hand-written kernels, recorded by wrappers put in
    place of the port's launch functions (trace runs only) while `on`: for
    each, what its work depends on, read without waiting for the card. The
    kernels come from the per-layer readers of the cell: key -> (module,
    function, shapes(args) -> record). The port's own launch counters are
    read beside."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.on = False
        self.pending: dict[str, list] = {}
        self._wrappers: dict[str, tuple] = {}
        self._start: dict[str, int] = {}
        self._installed = []

    def install(self) -> None:
        import importlib

        for key, (mod_name, fn_name, shapes) in self.kernels.items():
            try:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, fn_name)
            except (ImportError, AttributeError) as e:
                print(f"trace: {key}: no launch function to record ({e})", file=sys.stderr)
                continue
            wrapper = self._wrap(key, orig, shapes)
            setattr(mod, fn_name, wrapper)
            self._wrappers[key] = (wrapper, orig)
            self._installed.append((mod, fn_name, orig))

    def uninstall(self) -> None:
        for mod, fn_name, orig in self._installed:
            setattr(mod, fn_name, orig)
        self._installed = []

    def _wrap(self, key, orig, shapes):
        rec = self

        def wrapper(*args, **kwargs):
            if rec.on:
                rec.pending[key].append(shapes(args))
            return orig(*args, **kwargs)

        wrapper.launches = getattr(orig, "launches", 0)
        return wrapper

    def _count(self, key) -> int:
        wrapper, orig = self._wrappers[key]
        # the port's launch function adds to `<its name>.launches`, looked up
        # in its module, where the wrapper now stands
        return wrapper.launches + getattr(orig, "launches", 0)

    def start(self) -> None:
        for key in self._wrappers:
            self.pending[key] = []
            self._start[key] = self._count(key)
        self.on = True

    def stop(self) -> tuple[dict, dict]:
        """(records, launches) of the window, by kernel."""
        self.on = False
        records = {k: self.pending.pop(k, []) for k in self._wrappers}
        return records, {k: self._count(k) - self._start[k] for k in self._wrappers}


class Window:
    """One profiler window, started and stopped on the main thread (the one
    that set Kineto up)."""

    def __init__(self, recorder: Recorder | None):
        self.recorder = recorder
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []), acc_events=True)
        self.prof.start()
        if self.recorder is not None:
            self.recorder.start()
        self.t0 = time.perf_counter()

    def warm_up(self) -> None:
        """One short profile in set-up: the first start of the profiler (its
        CUPTI set-up) takes seconds, which must not fall into the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else []), acc_events=True):
            torch.ones(8, device="cuda" if cuda else "cpu").sum()
            if cuda:
                torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.work, self.launches = self.recorder.stop() if self.recorder else ({}, {})

    def view(self, dtype: str) -> View:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        device, host, gpu_ranges = [], [], {}
        for e in self.prof.events():
            user = bool(getattr(e, "is_user_annotation", False))
            span = Span(e.name, e.time_range.start, e.time_range.end)
            if e.device_type == cuda:
                if user:
                    gpu_ranges.setdefault(e.name, []).append(span)
                elif e.name != "Activity Buffer Request":
                    device.append(span)
            elif not e.is_async:
                host.append(span)
        v = View(window_s=self.t1 - self.t0, device=device, host=host, gpu_ranges=gpu_ranges,
                 work=self.work, launches=self.launches, dtype=dtype)
        print(f"trace: window {v.window_s:.3f} s, {len(device)} device events, "
              f"{len(host)} host events, device ranges {sorted(gpu_ranges)}", file=sys.stderr)
        return v
