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
     the f32 kernel path against the same weights' plain path on the CPU;
  6. masked flash attention kernel against its plain version (the AV-HuBERT
     and HuBERT shapes), f32 and bf16;
  7. bias-flash rel-position attention kernel against its plain version, and
     its time plus the bias construction beside the shear kernel of phase 3;
  8. the full-width multi_target_avhubert pipeline as in 5, with both
     rel-attention implementations (LIP2SPEECH_FLASH_IMPL shear | bias), and
     multi_target's batch-4 p50 under both;
  9. HuBERT unit extraction at full width: a 10 s waveform -> layer-6
     features -> 200 k-means units, against the CPU plain path;
 10. one request each through the multi_target_auto_avsr and
     multi_target_raven presets: shapes and launch counts.
Prints one JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {...}}. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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


def ragged_mask(t, dev, b=4):
    lens = [round(n * t / 240) for n in MAIN_LENS][:b]
    return lens, torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]


def valid_rows_err(out, ref, lens) -> float:
    if lens is None:
        return float((out.float() - ref).abs().max())
    return max(float((out.float() - ref)[i, :, :n].abs().max()) for i, n in enumerate(lens))


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
        lens, mask = ragged_mask(t, dev)
        out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
        f32 = [x.float() for x in (q_u, q_v, k, v, p)]
        ref = ra.dense_rel_attention(*f32, mask)            # same inputs, f32 math
        torch.cuda.synchronize()
        err = valid_rows_err(out, ref, lens)
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


def phase_plain_attention(att, dev) -> dict:
    """The masked attention kernel at the AV-HuBERT trunk's shape (B4 H16 T240 dk64, ragged), at a
    T that is not a tile multiple, and at HuBERT's (B1 H12, no mask, up to the
    4999 frames of a full extraction chunk)."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dk = 64
    result, failures = None, []
    cases = [(4, 16, 240, True, torch.bfloat16, True), (4, 16, 240, True, torch.float32, False),
             (4, 16, 235, True, torch.bfloat16, False), (4, 16, 235, True, torch.float32, False),
             (1, 12, 1499, False, torch.bfloat16, False), (1, 12, 1499, False, torch.float32, False),
             (1, 12, 4999, False, torch.float32, False),    # one 1.6 M-sample chunk
             (1, 12, 500, False, torch.float32, True)]
    for b, h, t, masked, dtype, timed in cases:
        q, k, v = (torch.randn(b, h, t, dk, generator=gen).to(dev, dtype) for _ in range(3))
        lens, mask = ragged_mask(t, dev, b) if masked else (None, None)
        out = att.attention_kernel(q, k, v, mask)
        ref = att.reference_attention(q.float(), k.float(), v.float(), mask)   # f32 math
        torch.cuda.synchronize()
        err = valid_rows_err(out, ref, lens)
        finite = bool(torch.isfinite(out.float()).all())
        tol = 1e-4 if dtype == torch.float32 else 2e-2      # bf16: output rounding
        name = str(dtype).replace("torch.", "")
        line = (f"attention B{b} H{h} T{t} {'ragged' if masked else 'no mask'} {name}: "
                f"max_abs_err {err:.3e} (tol {tol:g}) finite {finite}")
        if timed:
            k_ms = time_ms(lambda: att.attention_kernel(q, k, v, mask))
            plain_ms = time_ms(lambda: att.reference_attention(q, k, v, mask))
            lib_mask = None if mask is None else mask[:, None, None, :]
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=lib_mask))
            n_bytes = 4 * b * h * t * dk * q.element_size() + (b * t if masked else 0)
            bms, by = bound_ms(n_bytes, 4 * b * h * t * t * dk, dtype)
            line += (f" kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f}"
                     f" bound_ms {bms:.4f} ({by})")
            if dtype == torch.bfloat16:
                result = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
        print(line, flush=True)
        if not (err <= tol and finite):
            failures.append(line)
    if failures:
        fail("attention kernel disagrees with its plain version")
    return result


def phase_bias_attention(ra, dev, shear_ms: float) -> dict:
    """The bias-flash kernel at the conformer's shape (B4 H8 T480 dk64, ragged) and at
    T=470; its time and the bias construction's beside the shear kernel's."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(4)
    b, h, dk = 4, 8, 64
    result, failures = None, []
    for t, dtype in ((480, torch.bfloat16), (480, torch.float32),
                     (470, torch.bfloat16), (470, torch.float32)):
        mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
        q_u, q_v, k, v = (mk(b, h, t, dk) for _ in range(4))
        p = mk(h, 2 * t - 1, dk)
        lens, mask = ragged_mask(t, dev)
        bias = ra.rel_position_bias(q_v, p)                  # f32 whatever the input type
        out, lse = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)
        ref = ra.dense_bias_attention(q_u.float(), k.float(), v.float(), bias, mask)
        s = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.float()) / math.sqrt(dk) + bias
        lse_ref = torch.logsumexp(s.masked_fill(~mask[:, None, None, :], ra.NEG_INF), dim=-1)
        torch.cuda.synchronize()
        err = valid_rows_err(out, ref, lens)
        lse_err = valid_rows_err(lse[..., None], lse_ref[..., None], lens)
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        tol = 1e-4 if dtype == torch.float32 else 2e-2      # bf16: output rounding
        ok = err <= tol and lse_err <= 1e-3 and finite      # the LSE is f32 for both types
        name = str(dtype).replace("torch.", "")
        line = (f"rel_attention_bias B{b} H{h} T{t} {name}: max_abs_err {err:.3e} (tol {tol:g}) "
                f"lse_err {lse_err:.3e} (tol 0.001) finite {finite}")
        if t == 480:
            k_ms = time_ms(lambda: ra.rel_attention_bias_kernel(q_u, k, v, bias, mask))
            build_ms = time_ms(lambda: ra.rel_position_bias(q_v, p))
            plain_ms = time_ms(lambda: ra.dense_bias_attention(q_u, k, v, bias, mask))
            lib_bias = bias.masked_fill(~mask[:, None, None, :], ra.NEG_INF).to(dtype)
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q_u, k, v, attn_mask=lib_bias))
            sz = q_u.element_size()
            n_bytes = 4 * b * h * t * dk * sz + 4 * b * h * t * t + b * t + b * h * t * 4
            bms, by = bound_ms(n_bytes, 2 * 2 * b * h * t * t * dk, dtype)
            line += (f" kernel_ms {k_ms:.4f} bias_build_ms {build_ms:.4f} plain_ms {plain_ms:.4f}"
                     f" library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
            if dtype == torch.bfloat16:
                result = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": by, "library_ms": lib_ms, "bias_build_ms": build_ms}
        print(line, flush=True)
        if not ok:
            failures.append(line)
    if failures:
        fail("rel_attention_bias kernel disagrees with its plain version")
    print(f"rel-position attention B{b} H{h} T480 bf16: shear kernel_ms {shear_ms:.4f} | bias "
          f"build+kernel_ms {result['bias_build_ms'] + result['ms']:.4f}", flush=True)
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


def profile_request(pipe, video, mask, spk, what: str, top: int = 12) -> float:
    """Device time by kernel over one request, and the device's busy share
    of the request's wall time (torch.profiler, CUPTI). Returns the device's
    busy milliseconds."""
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
    return busy_ms


@contextlib.contextmanager
def flash_impl(impl: str):
    """Select the rel-position attention implementation, as a user would."""
    before = os.environ.get("LIP2SPEECH_FLASH_IMPL")
    os.environ["LIP2SPEECH_FLASH_IMPL"] = impl
    try:
        yield
    finally:
        if before is None:
            del os.environ["LIP2SPEECH_FLASH_IMPL"]
        else:
            os.environ["LIP2SPEECH_FLASH_IMPL"] = before


def counted_request(counters: dict, pipe, req, expected: dict, what: str):
    """One request with every launch count set to 0 just before and read just
    after; the counts must be exactly `expected` (kernels not named: 0).
    counters: kernel name -> wrapper with a .launches count."""
    for c in counters.values():
        c.launches = 0
    res = pipe.synthesise_batch(*req)
    counts = {name: c.launches for name, c in counters.items()}
    print(f"{what}: launches per forward {counts}", flush=True)
    want = {name: expected.get(name, 0) for name in counters}
    if counts != want:
        fail(f"{what}: expected launches {want}, got {counts}")
    return res


def p50_ms(pipe, req, calls: int = 10) -> tuple[float, float, float]:
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.synthesise_batch(*req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), min(times), max(times)


def n_trio_stages(vcfg) -> int:
    return sum(1 for i in range(len(vcfg.upsample_rates))
               if vcfg.upsample_initial_channel // 2 ** (i + 1) <= 128)


def f32_check(syn, cfg, what: str) -> None:
    """f32, TF32 off: the kernel path on the card against the same weights'
    plain path on the CPU at a small request; tolerance 1e-3."""
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
    print(f"{what} f32 kernel path vs plain path on the CPU (2 x 48 frames, no depth cut): "
          f"max_abs_err {errs} (tol 1e-3); "
          f"|logits| max {float(ref['unit_logits'].abs().max()):.3f} "
          f"|wav| max {float(wav_ref.abs().max()):.4f}", flush=True)
    if not all(e <= 1e-3 for e in errs.values()):
        fail(f"{what}: f32 kernel path disagrees with the plain path")


def phase_pipeline(syn, counters: dict, name: str, cfg, expected: dict) -> dict:
    """The full-width preset `name` in bf16 + PCM16 at both request shapes:
    exact launch counts per forward, results checked, p50 of 10 calls, one
    profiled request each. Then the bias implementation of rel-position
    attention: its launch counts, and the batch-4 p50 and device time of both
    implementations side by side. Then the f32 check. Returns the launch
    counts of the batch-4 run, with those of the bias run."""
    t0 = time.perf_counter()
    pipe = syn.Lip2SpeechPipeline.initialize_random(cfg, seed=0, compute_dtype=torch.bfloat16,
                                                    emit_int16=True)
    pipe.warmup(buckets=(240,), batch_sizes=(4,))
    pipe.warmup(buckets=(96,), batch_sizes=(1,))
    n_params = sum(p.numel() for m in (pipe.model, pipe.vocoder) for p in m.parameters())
    print(f"{name} bf16 init+warmup s {time.perf_counter() - t0:.1f} parameters "
          f"{n_params / 1e6:.1f} M", flush=True)
    launches = {}
    for b, frames, lens in ((4, 240, MAIN_LENS), (1, 96, (96,))):
        req = request(cfg, b, frames, lens, seed=b)
        res = counted_request(counters, pipe, req, expected, f"{name} B{b}x{frames}")
        if not launches:
            launches = {k: counters[k].launches for k in expected}
        check_results(res, lens, f"{name} B{b}x{frames}")
        p50, lo, hi = p50_ms(pipe, req)
        print(f"{name} B{b}x{frames} bf16 pcm16: p50_ms {p50:.3f} min_ms {lo:.3f} "
              f"max_ms {hi:.3f} (10 calls)", flush=True)
        profile_request(pipe, *req, f"{name} B{b}x{frames}")
    swapped = {("rel_attention_bias" if k == "rel_attention" else k): n
               for k, n in expected.items()}
    req = request(cfg, 4, 240, MAIN_LENS, seed=4)
    with flash_impl("bias"):
        res = counted_request(counters, pipe, req, swapped, f"{name} B4x240 impl=bias")
        launches["rel_attention_bias"] = counters["rel_attention_bias"].launches
        check_results(res, MAIN_LENS, f"{name} B4x240 impl=bias")
    p50s = {"shear": [], "bias": []}
    for impl in ("shear", "bias", "bias", "shear"):     # in turns, on one card
        with flash_impl(impl):
            p50s[impl].append(p50_ms(pipe, req)[0])
    busy = {}
    for impl in ("shear", "bias"):                      # device time is the stable reading
        with flash_impl(impl):
            busy[impl] = profile_request(pipe, *req, f"{name} B4x240 impl={impl}", top=0)
    print(f"{name} B4x240 bf16 pcm16 by rel-attention impl: p50_ms (2 x 10 calls each) "
          f"shear {p50s['shear']} bias {p50s['bias']}; device_busy_ms (one request each) "
          f"shear {busy['shear']:.3f} bias {busy['bias']:.3f}", flush=True)
    del pipe
    torch.cuda.empty_cache()
    f32_check(syn, cfg, name)
    return launches


def phase_units(ue, km, counters: dict) -> None:
    """HuBERT unit extraction at full width (12 heads, d 768, layer 6), f32:
    a 10 s waveform and 200 random centroids, against the CPU plain path."""
    set_tf32(False)
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal(160_000)).astype(np.float32)
    centroids = rng.standard_normal((200, 768)).astype(np.float32)
    gpu = ue.HubertFeatureExtractor.initialize_random(seed=0)
    cpu = ue.HubertFeatureExtractor(gpu.model.state_dict(), device="cpu")
    gpu.features(wav[:16_000])                              # builds, cuDNN picks algorithms
    for c in counters.values():
        c.launches = 0
    feats = gpu.features(wav)
    counts = {name: c.launches for name, c in counters.items()}
    print(f"unit extraction 160000 samples: features {feats.shape} launches per chunk {counts}",
          flush=True)
    if counts != {name: (6 if name == "attention" else 0) for name in counters}:
        fail(f"unit extraction: expected 6 attention launches per chunk, got {counts}")
    ref = cpu.features(wav)
    if feats.shape != (499, 768) or ref.shape != feats.shape or not np.isfinite(feats).all():
        fail(f"unit extraction: bad features {feats.shape} vs {ref.shape}")
    err = float(np.abs(feats - ref).max())
    labels = km.kmeans_apply(feats, centroids)
    labels_ref = km.kmeans_apply(ref, centroids, device="cpu")
    d = np.sort(((ref[:, None, :].astype(np.float64) - centroids[None]) ** 2).sum(-1), axis=1)
    clear = (d[:, 1] - d[:, 0]) > 1e-3 * d[:, 0]            # the two nearest centroids differ
    same = bool((labels == labels_ref)[clear].all())
    in_range = labels.dtype == np.int32 and labels.min() >= 0 and labels.max() < 200
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        km.kmeans_apply(gpu.features(wav), centroids)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    print(f"unit extraction f32: features max_abs_err vs CPU {err:.3e} (tol 1e-3); labels "
          f"{len(set(labels.tolist()))} distinct, equal on {int(clear.sum())}/{len(clear)} "
          f"clear frames: {same}; 10 s waveform p50_ms {float(np.median(times)):.3f} "
          f"min_ms {min(times):.3f} (5 calls)", flush=True)
    if not (err <= 1e-3 and same and in_range):
        fail("unit extraction disagrees with the CPU plain path")


def phase_other_frontends(syn, counters: dict, preset) -> None:
    """One batch 1 x 96 request through each of the two conformer-based
    frontends at full width: shapes and launch counts, no timing."""
    for name in ("multi_target_auto_avsr", "multi_target_raven"):
        cfg = preset(name)
        pipe = syn.Lip2SpeechPipeline.initialize_random(cfg, seed=0, compute_dtype=torch.bfloat16,
                                                        emit_int16=True)
        n_rel = cfg.model.frontend.encoder_layers + cfg.model.conformer.layers
        res = counted_request(counters, pipe, request(cfg, 1, 96, (96,), seed=1),
                              {"rel_attention": n_rel,
                               "fused_resblock_trio": n_trio_stages(cfg.vocoder)},
                              f"{name} B1x96")
        check_results(res, (96,), f"{name} B1x96")
        del pipe
        torch.cuda.empty_cache()


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
    from lip2speech_tpu_torch.ops import attention as att
    from lip2speech_tpu_torch.ops import fused_tail as ft
    from lip2speech_tpu_torch.ops import kmeans as km
    from lip2speech_tpu_torch.ops import rel_attention as ra
    from lip2speech_tpu_torch.pipeline import synthesise as syn
    from lip2speech_tpu_torch.pipeline import units_extract as ue

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

    counters = {"rel_attention": ra.rel_attention_kernel,
                "rel_attention_bias": ra.rel_attention_bias_kernel,
                "attention": att.attention_kernel,
                "fused_resblock_trio": ft.fused_resblock_trio_kernel}
    cfg = preset("multi_target")
    n_trio = n_trio_stages(cfg.vocoder)
    rel = phase_attention(ra, dev)
    trio = phase_trio(ft, dev, cfg.vocoder)
    plain = phase_plain_attention(att, dev)
    bias = phase_bias_attention(ra, dev, rel["ms"])
    phase_pipeline(syn, counters, "multi_target", cfg,
                   {"rel_attention": cfg.model.conformer.layers, "fused_resblock_trio": n_trio})
    flagship = preset("multi_target_avhubert")
    launches = phase_pipeline(
        syn, counters, "multi_target_avhubert", flagship,
        {"attention": flagship.model.frontend.encoder_layers,
         "rel_attention": flagship.model.conformer.layers, "fused_resblock_trio": n_trio})
    phase_units(ue, km, counters)
    phase_other_frontends(syn, counters, preset)
    pkg = "lip2speech_tpu_torch"
    jax_ops = "lip2speech_tpu/ops"
    kernels = [
        {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{source}",
         "replaces": f"{jax_ops}/{replaces}", "launches": launches[name], **numbers}
        for name, source, replaces, numbers in (
            ("rel_attention", "rel_attention.cu", "pallas_rel_attention.py:127", rel),
            ("fused_resblock_trio", "fused_tail.cu", "pallas_fused_tail.py:160", trio),
            ("rel_attention_bias", "rel_attention_bias.cu", "pallas_rel_attention.py:521", bias),
            ("attention", "attention.cu", "pallas_attention.py:30", plain))
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
