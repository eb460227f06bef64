#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lip2speech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from lip2speech_tpu_torch/csrc (nvcc, in parallel);
  3. rel-position attention kernel against its plain version, f32 and bf16;
  4. fused resblock-trio kernel against its plain version, per stage width;
  5. the full-width multi_target pipeline: bf16 + PCM16 requests at batch
     4 x 240 frames (ragged) and 1 x 96, launch counts per forward, p50; then
     the f32 kernel path against the same weights' plain path on the CPU.
Prints one JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {...}}. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,            # FP32, CUDA cores
              torch.bfloat16: 989e12}          # BF16 dense, tensor cores
MAIN_LENS = (240, 200, 150, 97)                # batch-4 request lengths


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def phase_attention(ra, dev) -> dict:
    """Kernel 1 at the main-path shape (B4 H8 T480 dk64) and at T=470."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(1)
    h, dk = 8, 64
    result, failures = None, []
    for t, dtype in ((480, torch.bfloat16), (480, torch.float32),
                     (470, torch.bfloat16), (470, torch.float32)):
        b = 4
        mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
        q_u, q_v, k, v = (mk(b, h, t, dk) for _ in range(4))
        p = mk(h, 2 * t - 1, dk)
        lens = [round(n * t / 240) for n in MAIN_LENS]
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
        f32 = [x.float() for x in (q_u, q_v, k, v, p)]
        ref = ra.dense_rel_attention(*f32, mask)            # same inputs, f32 math
        torch.cuda.synchronize()
        err = max(float((out.float() - ref)[i, :, :lens[i]].abs().max()) for i in range(b))
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        tol = 1e-4 if dtype == torch.float32 else 2e-2      # bf16: output rounding
        ok = err <= tol and finite
        name = str(dtype).replace("torch.", "")
        line = f"rel_attention B{b} H{h} T{t} {name}: max_abs_err {err:.3e} (tol {tol:g}) finite {finite}"
        if t == 480:
            k_ms = time_ms(lambda: ra.rel_attention_kernel(q_u, q_v, k, v, p, mask))
            plain_ms = time_ms(lambda: ra.dense_rel_attention(q_u, q_v, k, v, p, mask))
            scale = 1.0 / math.sqrt(dk)
            bias = ra.rel_shift(torch.einsum("bhqd,hpd->bhqp", q_v, p)) * scale
            bias = bias.masked_fill(~mask[:, None, None, :], ra.NEG_INF)
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q_u, k, v, attn_mask=bias))
            sz = q_u.element_size()
            n_bytes = 5 * b * h * t * dk * sz + h * (2 * t - 1) * dk * sz + b * t + b * h * t * 4
            bms, by = bound_ms(n_bytes, 3 * 2 * b * h * t * t * dk, dtype)
            line += (f" kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f}"
                     f" bound_ms {bms:.4f} ({by})")
            if dtype == torch.bfloat16:
                result = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        print(line, flush=True)
        if not ok:
            failures.append(line)
    if failures:
        fail("rel_attention kernel disagrees with its plain version")
    return result


def trio_weights(gen, c, ks, dils, dtype, dev):
    ws = []
    for k, ds in zip(ks, dils):
        std = 0.5 / math.sqrt(c * k)
        ws.append([tuple((torch.randn(c, c, k, generator=gen) * std,
                          torch.randn(c, generator=gen) * 0.1) for _ in range(2))
                   for _ in ds])
    return [[tuple((w.to(dev, dtype), b_.to(dev, dtype)) for w, b_ in pair) for pair in rb]
            for rb in ws]


def phase_trio(ft, dev, vcfg) -> dict:
    """Kernel 2 per stage width at the batch-4 x 240-frame row counts, plus a
    row count that is not a tile multiple."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(2)
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = [tuple(d) for d in vcfg.resblock_dilation_sizes]
    macs_per_row = sum(2 * k * len(d) for k, d in zip(ks, dils))  # x C^2
    b, frames = 4, 240
    rows = frames * 4                          # mel rows per item
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    bound_kind = set()
    failures = []
    c = vcfg.upsample_initial_channel
    for u in vcfg.upsample_rates:
        c //= 2
        rows *= u
        if c > 128:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            ws = trio_weights(gen, c, ks, dils, dtype, dev)
            name = str(dtype).replace("torch.", "")
            for m in (rows, 1000 + 37):
                x = (torch.randn(b if m == rows else 2, c, m, generator=gen) * 0.5).to(dev, dtype)
                out = ft.fused_resblock_trio_kernel(x, ws, ks, dils)
                ref = ft.trio_plain(x, ws, ks, dils)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                scale = max(1.0, float(ref.float().abs().max()))
                # f32: summation order only; bf16: both round after every op,
                # so a one-ulp split early in the 18-conv chain can propagate
                tol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
                finite = bool(torch.isfinite(out.float()).all())
                line = (f"fused_trio C{c} B{x.shape[0]} M{m} {name}: max_abs_err {err:.3e} "
                        f"(tol {tol:.3g}) finite {finite}")
                if m == rows:
                    k_ms = time_ms(lambda: ft.fused_resblock_trio_kernel(x, ws, ks, dils), iters=5)
                    p_ms = time_ms(lambda: ft.trio_plain(x, ws, ks, dils), iters=5)
                    n_bytes = 2 * x.numel() * x.element_size() + sum(
                        w.numel() * w.element_size() + bb.numel() * bb.element_size()
                        for rb in ws for pair in rb for w, bb in pair)
                    bms, by = bound_ms(n_bytes, 2 * macs_per_row * c * c * b * m, dtype)
                    line += f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {bms:.4f} ({by})"
                    if dtype == torch.bfloat16:
                        totals["ms"] += k_ms
                        totals["plain_ms"] += p_ms
                        totals["bound_ms"] += bms
                        totals["max_abs_err"] = max(totals["max_abs_err"], err)
                        bound_kind.add(by)
                print(line, flush=True)
                if not (err <= tol and finite):
                    failures.append(line)
    if failures:
        fail("fused trio kernel disagrees with its plain version")
    totals["bound_by"] = "/".join(sorted(bound_kind))
    totals["library_ms"] = None                 # no single PyTorch call does a trio
    return totals


def request(cfg, b, frames, lens, seed):
    rng = np.random.default_rng(seed)
    size = cfg.video.mouth_size
    video = rng.standard_normal((b, frames, size, size, 1)).astype(np.float32)
    mask = np.arange(frames)[None, :] < np.asarray(lens)[:, None]
    spk = rng.standard_normal((b, cfg.model.spk_emb_dim)).astype(np.float32)
    return video, mask, spk


def check_results(results, lens, what):
    for r, n in zip(results, lens):
        ok = (r.wav.shape == (n * 640,) and r.wav.dtype == np.int16
              and r.units.shape == (2 * n,) and r.units.min() >= 0 and r.units.max() < 200
              and r.mel.shape == (4 * n, 80) and r.mel.dtype == np.float16
              and np.isfinite(r.mel.astype(np.float32)).all())
        if not ok:
            fail(f"{what}: bad result wav {r.wav.shape} {r.wav.dtype} units {r.units.shape} "
                 f"mel {r.mel.shape} {r.mel.dtype}")


def profile_request(pipe, video, mask, spk, what: str, top: int = 12) -> None:
    """Device time by kernel over one request, and the device's busy share
    of the request's wall time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        pipe.synthesise_batch(video, mask, spk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    # device-side events only (kernels, copies, memsets): the aten:: rows
    # repeat the time of the kernels they launched
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
                   and e.key != "Activity Buffer Request"), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"profile {what}: wall_ms {wall_ms:.3f} (profiled) device_busy_ms {busy_ms:.3f} "
          f"busy_share {busy_ms / wall_ms:.3f} kernels {sum(e.count for e in rows)}", flush=True)
    for e in rows[:top]:
        print(f"profile {what}:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}",
              flush=True)


def phase_pipeline(ra, ft, syn, cfg) -> dict:
    counters = (ra.rel_attention_kernel, ft.fused_resblock_trio_kernel)
    n_layers = cfg.model.conformer.layers
    n_trio = sum(1 for i in range(len(cfg.vocoder.upsample_rates))
                 if cfg.vocoder.upsample_initial_channel // 2 ** (i + 1) <= 128)
    t0 = time.perf_counter()
    pipe = syn.Lip2SpeechPipeline.initialize_random(cfg, seed=0, compute_dtype=torch.bfloat16,
                                                    emit_int16=True)
    pipe.warmup(buckets=(240,), batch_sizes=(4,))
    pipe.warmup(buckets=(96,), batch_sizes=(1,))
    print(f"pipeline bf16 init+warmup s {time.perf_counter() - t0:.1f}", flush=True)
    launches = None
    for b, frames, lens in ((4, 240, MAIN_LENS), (1, 96, (96,))):
        video, mask, spk = request(cfg, b, frames, lens, seed=b)
        for c in counters:
            c.launches = 0
        res = pipe.synthesise_batch(video, mask, spk)
        counts = [c.launches for c in counters]
        print(f"pipeline B{b}x{frames}: launches rel_attention {counts[0]} "
              f"fused_trio {counts[1]} per forward", flush=True)
        if counts != [n_layers, n_trio]:
            fail(f"expected {n_layers} and {n_trio} launches per forward, got {counts}")
        if launches is None:
            launches = counts
        check_results(res, lens, f"B{b}x{frames}")
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipe.synthesise_batch(video, mask, spk)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        print(f"pipeline B{b}x{frames} bf16 pcm16: p50_ms {float(np.median(times)):.3f} "
              f"min_ms {min(times):.3f} max_ms {max(times):.3f} (10 calls)", flush=True)
        profile_request(pipe, video, mask, spk, f"B{b}x{frames}")
    del pipe
    torch.cuda.empty_cache()

    # f32, TF32 off: kernel path on the card vs the plain path on the CPU
    set_tf32(False)
    cpu = syn.Lip2SpeechPipeline.initialize_random(cfg, seed=0, device="cpu")
    gpu = syn.Lip2SpeechPipeline(cfg, cpu.model.state_dict(), cpu.vocoder.state_dict())
    video, mask, spk = request(cfg, 2, 48, (48, 30), seed=7)
    args = [torch.from_numpy(a) for a in (video, mask, spk)]
    with torch.inference_mode():
        ref = cpu.model(*args)
        got = gpu.model(*[a.cuda() for a in args])
        errs = {k: float((got[k].cpu() - ref[k]).abs().max()) for k in ("unit_logits", "mel")}
        n_special = cfg.model.units.num_special
        units = torch.where(ref["mask"], ref["unit_logits"][..., n_special:].argmax(-1), 0)
        wav_ref = cpu.vocoder(units, ref["mel"], args[2])
        wav = gpu.vocoder(units.cuda(), ref["mel"].cuda(), args[2].cuda())
        errs["wav"] = float((wav.cpu() - wav_ref).abs().max())
    print(f"f32 kernel path vs plain path: max_abs_err {errs} (tol 1e-3); "
          f"|logits| max {float(ref['unit_logits'].abs().max()):.3f} "
          f"|wav| max {float(wav_ref.abs().max()):.4f}", flush=True)
    if not all(e <= 1e-3 for e in errs.values()):
        fail("f32 kernel path disagrees with the plain path")
    return dict(zip(("rel_attention", "fused_resblock_trio"), launches))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "lip2speech_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lip2speech_tpu_torch.core.config import preset
    from lip2speech_tpu_torch.kernels import build
    from lip2speech_tpu_torch.ops import fused_tail as ft
    from lip2speech_tpu_torch.ops import rel_attention as ra
    from lip2speech_tpu_torch.pipeline import synthesise as syn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = build.build()
    print(f"build s {time.perf_counter() - t0:.2f} {built}", flush=True)
    for log in sorted(build._build_dir().glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {log.stem}: {line.strip()}", flush=True)

    cfg = preset("multi_target")
    attn = phase_attention(ra, dev)
    trio = phase_trio(ft, dev, cfg.vocoder)
    launches = phase_pipeline(ra, ft, syn, cfg)
    pkg = "lip2speech_tpu_torch"
    kernels = [
        {"name": "rel_attention", "route": "cuda", "source": f"{pkg}/csrc/rel_attention.cu",
         "replaces": "lip2speech_tpu/ops/pallas_rel_attention.py:127",
         "launches": launches["rel_attention"], **attn},
        {"name": "fused_resblock_trio", "route": "cuda", "source": f"{pkg}/csrc/fused_tail.cu",
         "replaces": "lip2speech_tpu/ops/pallas_fused_tail.py:160",
         "launches": launches["fused_resblock_trio"], **trio},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
