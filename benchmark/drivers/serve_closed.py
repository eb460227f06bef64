"""Closed-loop serving: `clients` threads each submit one clip of uint8 mouth
frames with a speaker embedding to the port's DynamicBatcher (what
`server.py --batcher` builds over a Lip2SpeechPipeline), wait for the
result and send the next. Lengths come from traffic.client_lengths; a mix
with a `segment` draws videos and sends each as its segments, one after
another with the video's speaker (traffic.segments). The frames come from a
seeded bank of random frames, each video a run of it.

Set-up builds the pipeline from the seed's weights and warms up every
(power-of-two batch, length bucket) the mix can reach. The window sends for
`seconds`; requests still open at its end are waited for.

Which requests are checked is drawn from the seed before the window: of
each client, some among its first `check_first`, and besides the longest
request the window completes. Their unit logits, as the pipeline's model
returned them, are kept on the card when produced (one copy a checked
request). Once the window has closed and the pipeline is freed, each is
held against the plain reference (f32, TF32 off), which runs stage 1 at
the bucket the request was served at and the vocoder on its own units and
mel:

  logit_err      |logits - logits_ref| / |logits_ref| over its valid steps
  unit_mismatch  served units that are not the reference's best, counted
                 where the reference's best two lie more than the limits
                 file's `unit_margin` apart (nearer, either is right)
  mel_err        |mel - mel_ref| / |mel_ref|
  wav_e2e_tf32x  |wav - wav_ref| / |wav_tf32 - wav_ref|: wav_ref the
                 reference vocoder's on the reference's units (the served
                 one where its best two lie within the margin) and its mel,
                 wav_tf32 the same with every convolution's operands
                 rounded to TF32: the served waveform's error in units of
                 TF32's on the same weights and inputs
logit_err, mel_err and wav_e2e_tf32x the largest over the checked requests,
unit_mismatch their sum. The waveform's own error swings by a hundred times
from seed to seed with the random weights, and TF32's on the same weights
with it: their ratio does not. Reported beside them: unit_gap, the widest
gap by which a served unit's reference logit lies below the reference's
best; logit_abs_err, the largest |logits - logits_ref| of one element;
near_ties, the steps whose best two lie within the margin; the waveform's
own error and TF32's, pooled over the checked requests.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from benchmark import harness, trace, traffic, work

MARK_CYCLES = 64        # the device markers of a traced run: a few microseconds each


@dataclass
class Request:
    client: int
    n: int
    offset: int
    spk: np.ndarray
    occ: int
    t_submit: float
    t_done: float = 0.0
    result: object = None
    error: Exception | None = None


class CallLog:
    """Stands in front of pipeline.synthesise_batch (the batcher's one call
    into the device): keeps the unit logits of the requests to check, and
    records each call's real lengths, bucket and rows. A request is known by
    its speaker embedding and how many requests with that embedding came
    before it: a client's requests come one after another.

    In a traced run it has the profiler window opened before the first call
    past `trace_from` and closed after the call that ends `trace_seconds`
    later. Kineto starts and stops only on the thread that set it up and
    records host ops of that thread alone, so the batcher's thread hands
    start and stop to the main thread (`serve`), and the calls' stage 1
    and vocoder are delimited on the device: a marker kernel before the
    model, before the vocoder and after it."""

    def __init__(self, pipe, wanted: set, window: trace.Window | None, trace_from: float,
                 trace_seconds: float):
        import torch

        self.pipe, self.window = pipe, window
        self.trace_from, self.trace_seconds = trace_from, trace_seconds
        self.inner = pipe.synthesise_batch
        self.wanted, self.logits = wanted, {}
        self.longest = (0, None)
        self.seen: dict = {}
        self.n_calls, self.n_rows = 0, 0
        self.rows: list = []
        self.in_window: list = []
        self.call_spans: list = []
        self.state = "before"
        self.requests: queue.Queue = queue.Queue()
        pipe.synthesise_batch = self
        pipe.model.register_forward_hook(self._keep_logits)
        if window is not None and pipe.device.type == "cuda":
            mark = lambda *a: torch.cuda._sleep(MARK_CYCLES)  # noqa: E731
            pipe.model.register_forward_pre_hook(mark)
            pipe.vocoder.register_forward_pre_hook(mark)
            pipe.vocoder.register_forward_hook(mark)

    def _keep_logits(self, module, args, out):
        for row, key, n in self.rows:
            self.logits[key] = out["unit_logits"][row, : 2 * n].clone()
        self.rows = []

    def _on_main(self, action) -> None:
        done = threading.Event()
        self.requests.put((action, done))
        done.wait()

    def serve(self, threads) -> None:
        """On the main thread until every client has ended: run what the
        batcher's thread hands over."""
        while any(th.is_alive() for th in threads):
            try:
                action, done = self.requests.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                action()
            finally:
                done.set()

    def __call__(self, video, frames_mask, spk_emb):
        mask = np.asarray(frames_mask, bool)
        lengths = mask.sum(1)
        self.n_calls += 1
        for row in range(len(mask)):
            n = int(lengths[row])
            if not n:
                continue
            self.n_rows += 1
            spk = spk_emb[row].tobytes()
            key = (spk, self.seen.get(spk, 0))
            self.seen[spk] = key[1] + 1
            if key in self.wanted or n > self.longest[0]:
                self.rows.append((row, key, n))
                if key not in self.wanted and n > self.longest[0]:
                    self.logits.pop(self.longest[1], None)
                    self.longest = (n, key)
        w = self.window
        if w is None:
            return self.inner(video, frames_mask, spk_emb)
        if self.state == "before" and time.perf_counter() >= self.trace_from:
            self._on_main(w.start)
            self.state = "open"
        t = time.perf_counter()
        out = self.inner(video, frames_mask, spk_emb)
        if self.state == "open":
            self.in_window.append(([int(x) for x in lengths if x], mask.shape[1], mask.shape[0]))
            self.call_spans.append(trace.Span(trace.CALL, (t - w.t0) * 1e6,
                                              (time.perf_counter() - w.t0) * 1e6))
            if time.perf_counter() - w.t0 >= self.trace_seconds:
                self._on_main(w.stop)
                self.state = "closed"
        return out

    def close(self):
        """On the main thread, after the batcher: a window still open ends."""
        if self.state == "open":
            self.window.stop()
            self.state = "closed"


def _plan(tr: dict, rng: np.random.Generator, bank_n: int) -> list[list[tuple]]:
    """Per client: (length, bank offset, speaker embedding, segment index) of
    each request, `lengths_per_client` videos (or clips) sent in turn."""
    plans = []
    order = np.random.default_rng(tr["order_seed"])
    for c in range(tr["clients"]):
        n = tr["lengths_per_client"]
        lens = traffic.client_lengths(tr["lengths"], n, order, c, tr["clients"], tr["block"])
        offsets = rng.integers(0, bank_n, n)
        spk = traffic.unit_speaker(rng, n)
        plan = []
        for a, b, s in zip(lens, offsets, spk):
            start = int(b)
            for k, seg in enumerate(traffic.segments(int(a), tr.get("segment"))):
                plan.append((seg, start, s, k))
                start += seg
        plans.append(plan)
    return plans


def _checked(tr: dict, plans, seed: int) -> set:
    """(client, index) of the requests to check, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    per = -(-tr["checked"] // tr["clients"])
    first = min([tr["check_first"]] + [len(p) for p in plans])
    return {(c, int(j)) for c in range(len(plans))
            for j in rng.choice(first, size=min(per, first), replace=False)}


def _frames(bank, n, offset):
    return bank[(offset + np.arange(n)) % len(bank)]


def run(rc) -> dict:
    import torch
    from lip2speech_tpu_torch.data.stage1 import pick_bucket
    from lip2speech_tpu_torch.pipeline.batcher import DynamicBatcher
    from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline

    conf, tr = rc.cell.config, rc.cell.traffic
    dev = torch.device(rc.device)
    phases = {"imports": time.perf_counter() - rc.t_start}
    harness.set_precision(conf)
    cfg = harness.port_config(conf, rc.overrides)
    dtype = {"float32": None, "bfloat16": torch.bfloat16}[rc.dtype or conf["dtype"]]
    s1, voc = harness.make_weights(cfg, harness.sub_seed(rc.seed, 1), dev)
    with torch.device(dev):
        pipe = Lip2SpeechPipeline(cfg, s1, voc, compute_dtype=dtype, emit_int16=False, device=dev)
    del s1, voc
    for hook in rc.hooks.get("pipeline", ()):
        hook(pipe)
    phases["weights_and_pipeline"] = time.perf_counter() - rc.t_start

    rng = np.random.default_rng(rc.seed)
    size = tr["frame_size"]
    bank = rng.integers(0, 256, (tr["frame_bank"], size, size), dtype=np.uint8)
    plans = _plan(tr, rng, len(bank))
    checked = _checked(tr, plans, rc.seed)
    buckets = sorted({pick_bucket(n) for plan in plans for n, _, _, _ in plan})
    sizes = [1 << i for i in range(tr["max_batch"].bit_length()) if 1 << i <= tr["max_batch"]]
    mouth = cfg.video.mouth_size
    for b in sizes:
        for t in buckets:
            pipe.synthesise_batch(np.zeros((b, t, mouth, mouth, 1), np.float32),
                                  np.ones((b, t), bool), np.zeros((b, 256), np.float32))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["warm_up"] = time.perf_counter() - rc.t_start
    window = None
    if rc.trace:
        recorder = trace.Recorder(harness.kernels_to_record(rc.cell))
        recorder.install()
        window = trace.Window(recorder)
        window.warm_up()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_end = t0 + rc.seconds
    calls = CallLog(pipe, {(plans[c][j][2].tobytes(), plans[c][j][3]) for c, j in checked},
                    window,
                    t0 + tr["trace_after_s"], tr["trace_seconds"])
    batcher = DynamicBatcher(pipe, max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = t0 - rc.t_start
    records: list[Request] = []

    def client(c: int):
        seen: dict = {}
        for j in range(10 ** 9):
            t = time.perf_counter()
            if t >= t_end:
                return
            n, off, spk, _ = plans[c][j % len(plans[c])]
            occ = seen.get(spk.tobytes(), 0)
            seen[spk.tobytes()] = occ + 1
            req = Request(c, n, off, spk, occ, t)
            try:
                req.result = batcher.synthesise(_frames(bank, n, off), spk, timeout=tr["timeout_s"])
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not raised
                req.error = e
            req.t_done = time.perf_counter()
            records.append(req)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(tr["clients"])]
    for th in threads:
        th.start()
    calls.serve(threads)
    for th in threads:
        th.join()
    batcher.close()
    calls.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    spf = cfg.model.units.mel_per_frame * cfg.audio.hop_length
    sr = cfg.audio.sample_rate
    done = [r for r in records if r.error is None and r.t_done <= t_end]
    lat_ms = [1e3 * (r.t_done - r.t_submit) for r in done]
    out = {"attempted": len(records), "failed": sum(r.error is not None for r in records),
           "setup_s": setup_s, "memory_peak_bytes": int(peak),
           "e2e": {"speech_rtf": sum(r.n * spf / sr for r in done) / rc.seconds,
                   "latency_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else None},
           "counts": {"completed_in_window": len(done), "calls": calls.n_calls,
                      "rows_per_call": calls.n_rows / max(calls.n_calls, 1),
                      "setup_phases_s": phases}}
    if window is not None:
        recorder.uninstall()
        if calls.state == "closed":
            view = window.view(rc.dtype or conf["dtype"])
            view.calls = calls.in_window
            view.host_marks = calls.call_spans
            view.markers = (r"spin_kernel", (trace.STAGE1, trace.VOCODER, None))
            lengths = [n for ls, _, _ in calls.in_window for n in ls]
            view.model_flops = sum(work.request_flops(conf["arch"], n) for n in lengths)
            view.speech_s = sum(n * spf / sr for n in lengths)
            out["view"] = view

    # the reference, once the program's state is freed
    by_key = {(r.spk.tobytes(), r.occ): r for r in records if r.error is None}
    sample = [(by_key[k], v) for k, v in calls.logits.items() if k in by_key]
    del batcher, pipe, calls
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"] = _compare(rc, cfg, conf, bank, sample, dev) if sample else {}
    return out


def _ratio(wavs: list) -> float:
    return max(d / t if t > 0 else (0.0 if d == 0 else float("inf")) for d, _, t in wavs)


def _pooled(wavs: list, i: int) -> float:
    return float(np.sqrt(sum(w[i] ** 2 for w in wavs) / sum(w[1] ** 2 for w in wavs)))


def _compare(rc, cfg, conf, bank, sample: list, dev) -> dict:
    import torch
    from lip2speech_tpu_torch.data.stage1 import pick_bucket

    from benchmark.reference import stage1 as ref, video as ref_video, vocoder as ref_voc

    harness.plain_precision()
    s1, voc = harness.make_weights(cfg, harness.sub_seed(rc.seed, 1), dev)
    arch = conf["arch"]
    ns = arch["num_special"]
    margin = float(rc.cell.limits["unit_margin"])
    num = {"logit_err": 0.0, "unit_mismatch": 0, "mel_err": 0.0}
    seen = {"unit_gap": 0.0, "logit_abs_err": 0.0, "near_ties": 0}
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    wavs = []
    with torch.no_grad():
        for r, logits in sample:
            n, t = r.n, pick_bucket(r.n)
            v = np.zeros((1, t, 88, 88, 1), np.float32)
            v[0, :n, :, :, 0] = ref_video.prepare(_frames(bank, n, r.offset))
            mask = torch.zeros((1, t), dtype=torch.bool, device=dev)
            mask[0, :n] = True
            spk = torch.as_tensor(r.spk[None], device=dev)
            o = ref.forward(s1, arch, torch.as_tensor(v, device=dev), mask, spk)
            ref_logits = o["unit_logits"][0, : 2 * n].double()
            num["logit_err"] = max(num["logit_err"], rel(logits.double(), ref_logits))
            seen["logit_abs_err"] = max(seen["logit_abs_err"],
                                        float((logits.double() - ref_logits).abs().max()))
            units = torch.as_tensor(np.asarray(r.result.units, np.int64), device=dev)
            top = ref_logits[:, ns:].topk(2, dim=1)
            clear = top.values[:, 0] - top.values[:, 1] > margin
            num["unit_mismatch"] += int(((units != top.indices[:, 0]) & clear).sum())
            seen["near_ties"] += int((~clear).sum())
            served = ref_logits[:, ns:].gather(1, units[:, None])[:, 0]
            seen["unit_gap"] = max(seen["unit_gap"], float((top.values[:, 0] - served).max()))
            mel_s = torch.as_tensor(np.asarray(r.result.mel, np.float32), device=dev)
            num["mel_err"] = max(num["mel_err"], rel(mel_s.double(), o["mel"][0, : 4 * n].double()))
            wav_s = torch.as_tensor(np.asarray(r.result.wav, np.float32), device=dev).double()
            code = torch.zeros((1, 2 * t), dtype=torch.int64, device=dev)
            code[0, : 2 * n] = torch.where(clear, top.indices[:, 0], units)
            m = len(wav_s)
            wav_r = ref_voc.generate(voc, arch["vocoder"], code, o["mel"], spk)[0, :m].double()
            wav_t = ref_voc.generate(voc, arch["vocoder"], code, o["mel"], spk,
                                     operand=ref_voc.tf32)[0, :m].double()
            wavs.append((float((wav_s - wav_r).norm()), float(wav_r.norm()),
                         float((wav_t - wav_r).norm())))
    num["wav_e2e_tf32x"] = _ratio(wavs)
    return {**num, **seen, "checked": len(sample), "longest": max(r.n for r, _ in sample),
            "wav_err": _pooled(wavs, 0), "wav_tf32_err": _pooled(wavs, 2)}
