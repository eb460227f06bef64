#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lip2speech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from lip2speech_tpu_torch/csrc (nvcc, in parallel);
     print ptxas's registers and spills, and count the tensor-core (HMMA)
     instructions in each library's SASS: none in rel_attention,
     rel_attention_bwd, rel_attention_bias, rel_attention_bias_bwd,
     attention or fused_tail (bf16 on mma.sync) fails;
  3. rel-position attention kernel against its plain version, f32 and bf16;
     times at B4 H8 T480 and at the train step's B8 H8 T1200, each beside
     SDPA with the position term as a float bias mask;
  4. fused resblock-trio kernel against its plain version, per stage width;
     each stage's time beside its plain version (cuDNN's 18 convs) and its
     bound at the batch-4 x 240-frame and batch-1 x 96-frame row counts;
  5. the full-width multi_target pipeline: bf16 + PCM16 requests at batch
     4 x 240 frames (ragged) and 1 x 96, launch counts per forward, p50; then
     the f32 kernel path against the same weights' plain path on the CPU;
  6. masked flash attention kernel against its plain version (the AV-HuBERT
     and HuBERT shapes, a fully masked batch row), f32 and bf16; bf16 times
     at B4 H16 T240 and at the flagship train step's B8 H16 T600 beside
     SDPA and the bound;
  7. bias-flash rel-position attention kernel against its plain version
     (T 480 / 470, f32 and bf16), and its time plus the bias construction
     beside the shear kernel of phase 3; bf16 times at B4 H8 T480 and at the
     train step's B8 H8 T1200, each beside its plain version, SDPA with the
     same bias and the bound (bytes and operations);
  8. the full-width multi_target_avhubert pipeline as in 5, with both
     rel-attention implementations (LIP2SPEECH_FLASH_IMPL shear | bias), and
     multi_target's batch-4 p50 under both;
  9. HuBERT unit extraction at full width: a 10 s waveform -> layer-6
     features -> 200 k-means units, against the CPU plain path;
 10. one request each through the multi_target_auto_avsr and
     multi_target_raven presets: shapes and launch counts;
 11. the backward kernels of both rel-position attention routes against
     their plain versions and against autograd through the dense forward,
     f32 and bf16, T 235 / 470 / 1200, ragged with one fully masked batch
     row; the bias route's dbias also by its own limits (DBIAS_TOL), which
     two faulty dbias made from the kernel's must fail; both kernels' bf16
     times at B4 H8 T480 and B8 H8 T1200 beside their plain versions, SDPA's
     backward and the bound (bytes and operations), the bias route's also
     beside the autograd of the bias construction;
 12. in-kernel attention dropout, both routes, forward and backward, against
     the plain versions under the identical keep mask (dbias by DBIAS_TOL);
     the kernel's mask against ops/dropout_mask.py; determinism, keep rate,
     unbiasedness;
 13. stage-1 training of multi_target at full width (no depth cut): bf16
     compute, dropout 0.1, micro-batch 8 x 600 frames, accumulation 2, three
     optimizer steps with exact launch counts, one profiled step, one step
     with the bias route; then two f32 steps on the card against the CPU
     plain path; then one step of the flagship multi_target_avhubert
     (frozen frontend: no gradient, no update).
Kernel times are device time (CUDA events, host enqueue hidden behind a
device sleep). Prints one JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {...}}. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    """Device milliseconds per call of fn: CUDA events around `iters` calls,
    queued behind a ~10 ms device sleep so that the host's enqueue time (the
    wrappers' checks, ~0.05-0.1 ms a call) does not show between kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def both_bounds_ms(n_bytes: float, flops: float, dtype) -> dict:
    """The byte and the operation bound apart, and the larger of the two."""
    bms, by = bound_ms(n_bytes, flops, dtype)
    return {"bound_ms": bms, "bound_by": by, "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "operations_bound_ms": flops / PEAK_FLOPS[dtype] * 1e3}


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ragged_mask(t, dev, b=4):
    lens = ([round(n * t / 240) for n in MAIN_LENS] * ((b + 3) // 4))[:b]
    return lens, torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]


def valid_rows_err(out, ref, lens) -> float:
    if lens is None:
        return float((out.float() - ref).abs().max())
    return max(float((out.float() - ref)[i, :, :n].abs().max()) for i, n in enumerate(lens) if n)


# libraries whose bf16 path runs on mma.sync
TENSOR_CORE_KERNELS = ("rel_attention", "rel_attention_bwd", "rel_attention_bias",
                       "rel_attention_bias_bwd", "attention", "fused_tail")


def sass_tensor_core_counts(build) -> dict:
    """HMMA instructions in each kernel library's SASS (cuobjdump); fails if
    a library whose bf16 path runs on mma.sync has none."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    counts = {}
    for lib in sorted(build._build_dir().glob("lib*.so")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        counts[lib.stem[3:]] = sum(1 for line in sass.splitlines() if "HMMA" in line)
    print(f"SASS HMMA instructions per library: {counts}", flush=True)
    missing = [k for k in TENSOR_CORE_KERNELS if not counts.get(k)]
    if missing:
        fail(f"no tensor-core instruction in {missing}")
    return counts


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
    result["train_shape"] = rel_attention_train_shape(ra, dev, gen)
    return result


def rel_attention_train_shape(ra, dev, gen) -> dict:
    """Kernel 1 at the train step's shape (B8 H8 T1200 bf16, all keys
    valid): its time beside its bound, the plain version and SDPA with the
    position term as a float bias mask (the library yardstick for kernels 1
    and 4 there; SDPA is handed the bias, whose construction is timed
    apart)."""
    b, h, t = TRAIN_SHAPE
    dk, dtype = 64, torch.bfloat16
    mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
    q_u, q_v, k, v = (mk(b, h, t, dk) for _ in range(4))
    p = mk(h, 2 * t - 1, dk)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    k_ms = time_ms(lambda: ra.rel_attention_kernel(q_u, q_v, k, v, p, mask), iters=10)
    plain_ms = time_ms(lambda: ra.dense_rel_attention(q_u, q_v, k, v, p, mask), iters=3)
    build_ms = time_ms(lambda: ra.rel_position_bias(q_v, p).to(dtype), iters=5)
    bias = ra.rel_position_bias(q_v, p).to(dtype)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_u, k, v, attn_mask=bias), iters=10)
    n_bytes = 5 * b * h * t * dk * 2 + h * (2 * t - 1) * dk * 2 + b * t + b * h * t * 4
    bms, by = bound_ms(n_bytes, 3 * 2 * b * h * t * t * dk, dtype)
    print(f"rel_attention B{b} H{h} T{t} bf16: kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (SDPA, float bias mask; building the bf16 bias "
          f"{build_ms:.4f} ms) bound_ms {bms:.4f} ({by})", flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bias_build_ms": build_ms,
            "bound_ms": bms, "bound_by": by}


def phase_plain_attention(att, dev) -> dict:
    """The masked attention kernel at the AV-HuBERT trunk's shape (B4 H16 T240 dk64, ragged), at a
    T that is not a tile multiple (also with a fully masked batch row, held
    whole against the plain version's uniform average), at the shape the
    flagship's train step gives it (B8 H16 T600), and at HuBERT's (B1 H12,
    no mask, up to the 4999 frames of a full extraction chunk). bf16 times
    at B4 H16 T240 and B8 H16 T600."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dk = 64
    result, failures = None, []
    cases = [(4, 16, 240, "ragged", torch.bfloat16, True), (4, 16, 240, "ragged", torch.float32, False),
             (4, 16, 235, "ragged", torch.bfloat16, False), (4, 16, 235, "ragged", torch.float32, False),
             (4, 16, 235, "empty row", torch.bfloat16, False),
             (4, 16, 235, "empty row", torch.float32, False),
             (8, 16, 600, "ragged", torch.bfloat16, True), (8, 16, 600, "ragged", torch.float32, False),
             (1, 12, 1499, "no mask", torch.bfloat16, False),
             (1, 12, 1499, "no mask", torch.float32, False),
             (1, 12, 4999, "no mask", torch.float32, False),    # one 1.6 M-sample chunk
             (1, 12, 500, "no mask", torch.float32, True)]
    for b, h, t, masking, dtype, timed in cases:
        q, k, v = (torch.randn(b, h, t, dk, generator=gen).to(dev, dtype) for _ in range(3))
        if masking == "ragged":
            lens, mask = ragged_mask(t, dev, b)
        elif masking == "empty row":     # batch row 2 has no valid key: compared whole
            mask = torch.arange(t, device=dev)[None, :] < torch.tensor(
                [t, round(0.83 * t), 0, round(0.4 * t)], device=dev)[:, None]
            lens = None
        else:
            lens, mask = None, None
        out = att.attention_kernel(q, k, v, mask)
        ref = att.reference_attention(q.float(), k.float(), v.float(), mask)   # f32 math
        torch.cuda.synchronize()
        err = valid_rows_err(out, ref, lens)
        finite = bool(torch.isfinite(out.float()).all())
        tol = 1e-4 if dtype == torch.float32 else 2e-2      # bf16: P and output rounding
        name = str(dtype).replace("torch.", "")
        line = (f"attention B{b} H{h} T{t} {masking} {name}: "
                f"max_abs_err {err:.3e} (tol {tol:g}) finite {finite}")
        if timed:
            k_ms = time_ms(lambda: att.attention_kernel(q, k, v, mask))
            plain_ms = time_ms(lambda: att.reference_attention(q, k, v, mask))
            lib_mask = None if mask is None else mask[:, None, None, :]
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=lib_mask))
            n_bytes = 4 * b * h * t * dk * q.element_size() + (b * t if mask is not None else 0)
            bms, by = bound_ms(n_bytes, 4 * b * h * t * t * dk, dtype)
            line += (f" kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f}"
                     f" bound_ms {bms:.4f} ({by})")
            numbers = {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms}
            if dtype == torch.bfloat16 and result is None:
                result = {"max_abs_err": err, **numbers}
            elif dtype == torch.bfloat16:
                result["train_shape"] = numbers
        if dtype == torch.bfloat16 and result is not None:
            result["max_abs_err"] = max(result["max_abs_err"], err)
        print(line, flush=True)
        if not (err <= tol and finite):
            failures.append(line)
    if failures:
        fail("attention kernel disagrees with its plain version")
    return result


def bias_fwd_times(ra, gen, dev, b, h, t, mask=None) -> dict:
    """Kernel 4 in bf16 beside its plain version, SDPA with the same bias
    (cast to bf16, masked keys at -1e30) and its bound; the bias
    construction apart. mask None: all keys valid."""
    dtype, dk = torch.bfloat16, 64
    mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
    q_u, q_v, k, v = (mk(b, h, t, dk) for _ in range(4))
    p = mk(h, 2 * t - 1, dk)
    if mask is None:
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    bias = ra.rel_position_bias(q_v, p)
    iters = 20 if t < 1000 else 10
    k_ms = time_ms(lambda: ra.rel_attention_bias_kernel(q_u, k, v, bias, mask), iters=iters)
    build_ms = time_ms(lambda: ra.rel_position_bias(q_v, p), iters=5)
    plain_ms = time_ms(lambda: ra.dense_bias_attention(q_u, k, v, bias, mask), iters=3)
    lib_bias = bias.masked_fill(~mask[:, None, None, :], ra.NEG_INF).to(dtype)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q_u, k, v, attn_mask=lib_bias), iters=iters)
    # q_u k v in and out written once, the f32 bias, the mask, the f32 LSE
    n_bytes = 4 * b * h * t * dk * 2 + 4 * b * h * t * t + b * t + b * h * t * 4
    bounds = both_bounds_ms(n_bytes, 2 * 2 * b * h * t * t * dk, dtype)
    print(f"rel_attention_bias B{b} H{h} T{t} bf16: kernel_ms {k_ms:.4f} bias_build_ms {build_ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA, the same bias) bound_ms "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']}; bytes {bounds['bytes_bound_ms']:.4f}, "
          f"operations {bounds['operations_bound_ms']:.4f})", flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bias_build_ms": build_ms,
            **bounds}


def phase_bias_attention(ra, dev, shear_ms: float) -> dict:
    """The bias-flash kernel at the conformer's shape (B4 H8 T480 dk64, ragged) and at
    T=470, f32 and bf16, against its plain version; bf16 times there and at
    the train step's B8 H8 T1200, with the bias construction's beside the
    shear kernel's."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(4)
    b, h, dk = 4, 8, 64
    worst, failures = 0.0, []
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
        tol = 1e-4 if dtype == torch.float32 else 2e-2      # bf16: P and output rounding
        ok = err <= tol and lse_err <= 1e-3 and finite      # the LSE is f32 for both types
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        name = str(dtype).replace("torch.", "")
        line = (f"rel_attention_bias B{b} H{h} T{t} {name}: max_abs_err {err:.3e} (tol {tol:g}) "
                f"lse_err {lse_err:.3e} (tol 0.001) finite {finite}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
    if failures:
        fail("rel_attention_bias kernel disagrees with its plain version")
    result = {"max_abs_err": worst, **bias_fwd_times(ra, gen, dev, b, h, 480, ragged_mask(480, dev)[1]),
              "train_shape": bias_fwd_times(ra, gen, dev, *TRAIN_SHAPE)}
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
    row count that is not a tile multiple, and (bf16) at the batch-1 x
    96-frame row counts. Returns the bf16 totals at batch 4 with each
    stage's numbers at both request shapes."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(2)
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = [tuple(d) for d in vcfg.resblock_dilation_sizes]
    macs_per_row = sum(2 * k * len(d) for k, d in zip(ks, dils))  # x C^2
    b, frames = 4, 240
    rows = frames * 4                          # mel rows per item
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    stages = []
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
            shapes = [(b, rows, "B4x240"), (2, 1000 + 37, None)]
            if dtype == torch.bfloat16:
                shapes.append((1, rows * 96 // 240, "B1x96"))
                stage = {"channels": c}
            for bsz, m, timed in shapes:
                x = (torch.randn(bsz, c, m, generator=gen) * 0.5).to(dev, dtype)
                out = ft.fused_resblock_trio_kernel(x, ws, ks, dils)
                ref = ft.trio_plain(x, ws, ks, dils)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                scale = max(1.0, float(ref.float().abs().max()))
                # f32: summation order only; bf16: both round after every op,
                # so a one-ulp split early in the 18-conv chain can propagate
                tol = (1e-4 if dtype == torch.float32 else 3e-2) * scale
                finite = bool(torch.isfinite(out.float()).all())
                line = (f"fused_trio C{c} B{bsz} M{m} {name}: max_abs_err {err:.3e} "
                        f"(tol {tol:.3g}) finite {finite}")
                if timed:
                    k_ms = time_ms(lambda: ft.fused_resblock_trio_kernel(x, ws, ks, dils), iters=5)
                    p_ms = time_ms(lambda: ft.trio_plain(x, ws, ks, dils), iters=5)
                    n_bytes = 2 * x.numel() * x.element_size() + sum(
                        w.numel() * w.element_size() + bb.numel() * bb.element_size()
                        for rb in ws for pair in rb for w, bb in pair)
                    bms, by = bound_ms(n_bytes, 2 * macs_per_row * c * c * bsz * m, dtype)
                    tile = ft.tile_rows(c, dtype, ft._geometry(ks, dils)[1], m, bsz,
                                        ft._sm_count(x.device), ks, tuple(dils))
                    line += (f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {bms:.4f} ({by})"
                             f" tile {tile} blocks {bsz * -(-m // tile)}")
                    if dtype == torch.bfloat16:
                        stage[timed] = {"rows": m, "batch": bsz, "ms": k_ms, "plain_ms": p_ms,
                                        "bound_ms": bms, "tile": tile}
                        if timed == "B4x240":
                            totals["ms"] += k_ms
                            totals["plain_ms"] += p_ms
                            totals["bound_ms"] += bms
                            bound_kind.add(by)
                if dtype == torch.bfloat16:
                    totals["max_abs_err"] = max(totals["max_abs_err"], err)
                print(line, flush=True)
                if not (err <= tol and finite):
                    failures.append(line)
            if dtype == torch.bfloat16:
                stages.append(stage)
    if failures:
        fail("fused trio kernel disagrees with its plain version")
    slower = [f"C{st['channels']} {shape}" for st in stages for shape in ("B4x240", "B1x96")
              if st[shape]["ms"] > st[shape]["plain_ms"]]
    print(f"fused_trio bf16 B4x240 four stages: kernel_ms {totals['ms']:.4f} plain_ms "
          f"{totals['plain_ms']:.4f} bound_ms {totals['bound_ms']:.4f}; stages slower than "
          f"their plain version: {slower or 'none'}", flush=True)
    totals["bound_by"] = "/".join(sorted(bound_kind))
    totals["library_ms"] = None                 # no single PyTorch call does a trio
    totals["stages"] = stages
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


def profile_call(fn, what: str, top: int = 12) -> float:
    """Device time by kernel over one call of fn, and the device's busy share
    of the call's wall time (torch.profiler, CUPTI). Returns the device's
    busy milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t = time.perf_counter()
        fn()
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
        profile_call(lambda: pipe.synthesise_batch(*req), f"{name} B{b}x{frames}")
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
            busy[impl] = profile_call(lambda: pipe.synthesise_batch(*req),
                                      f"{name} B4x240 impl={impl}", top=0)
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


TRAIN_SHAPE = (8, 8, 1200)        # B, H, T of the recipe: 8 x 600 frames, 2 tokens a frame


def bwd_inputs(gen, b, h, t, dtype, dev):
    """Random inputs of the backward kernels: ragged lengths, batch row 2
    fully masked, the upstream gradient zero on padded query rows."""
    mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
    q_u, q_v, k, v = (mk(b, h, t, 64) for _ in range(4))
    p = mk(h, 2 * t - 1, 64)
    lens = ([t, round(0.83 * t), 0, round(0.4 * t)] * ((b + 3) // 4))[:b]
    mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    g = (mk(b, h, t, 64) * mask[:, None, :, None]).contiguous()
    return (q_u, q_v, k, v, p), mask, g


def grad_errs(got, ref):
    """Max abs error of each gradient over max(1, max |ref|)."""
    return [float((a.float() - r.float()).abs().max()) / max(1.0, float(r.float().abs().max()))
            for a, r in zip(got, ref)]


def autograd_ref(fn, inputs, g):
    """Gradients of fn(*inputs) by PyTorch's autograd, in f32."""
    leaves = [x.float().detach().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, g.float())


def bwd_tolerance(dtype) -> float:
    # f32: summation order (and atomics for dp); bf16: the gradients are
    # rounded to bf16 on output (2^-9 of their magnitude) and the saved
    # forward output that enters D = rowsum(dO o O) is bf16 too
    return 1e-4 if dtype == torch.float32 else 1e-2


# dbias is the f32 dS = P o (dPr - D), unscaled and never rounded, in both
# types, and the kernels and the plain version take D from the same forward
# output: it agrees with the plain version to f32 summation order (5e-7 to
# 9e-7 of max(1, |ref|) in bf16). Its entries are small (P ~ 1/T), so the
# gradients' 1e-2 would pass a dbias wrong in most of them; it has limits of
# its own, on the largest error and on the RMS error over the RMS of ref.
DBIAS_TOL = {"max": 1e-5, "rms": 1e-4}


def dbias_errs(got, ref) -> dict:
    """dbias's max abs error over max(1, max |ref|), and its RMS error over
    ref's RMS, which moves when many small entries are wrong."""
    ref = ref.float()
    d = got.float() - ref
    return {"max": float(d.abs().max()) / max(1.0, float(ref.abs().max())),
            "rms": float(d.square().mean().sqrt() / ref.square().mean().sqrt())}


def dbias_ok(errs: dict) -> bool:
    return all(errs[k] <= DBIAS_TOL[k] for k in DBIAS_TOL)


def dbias_faults(got, ref) -> dict:
    """The errors of two faulty dbias made from the kernel's: dS rounded to
    bf16 before it is written, and the entries under 1% of the largest
    lost. The limits must fail both."""
    small = ref.abs() < 0.01 * ref.abs().max()
    return {"bf16": dbias_errs(got.to(torch.bfloat16), ref),
            "small_lost": dbias_errs(torch.where(small, 0.0, got), ref)}


def fmt_errs(errs: dict) -> str:
    return f"max {errs['max']:.2e} rms {errs['rms']:.2e}"


def sdpa_bwd_ms(q, k, v, bias, g) -> float:
    """The backward of one scaled_dot_product_attention call with the
    position bias as a float mask (the library yardstick)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return time_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), iters=5)


def shear_bwd_times(ra, gen, dev, b, h, t) -> dict:
    """Kernel 3 (bf16, all keys valid) beside its bound, its plain version
    and the backward of SDPA with the position term as a float bias mask."""
    dtype, dk, sz = torch.bfloat16, 64, 2
    (q_u, q_v, k, v, p), _, g = bwd_inputs(gen, b, h, t, dtype, dev)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
    k_ms = time_ms(lambda: ra.rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g), iters=10)
    plain_ms = time_ms(lambda: ra.rel_attention_bwd_plain(q_u, q_v, k, v, p, mask, lse, out, g), iters=3)
    lib_ms = sdpa_bwd_ms(q_u, k, v, ra.rel_position_bias(q_v, p).to(dtype), g)
    # inputs q_u q_v k v out dO and p, mask, lse once; outputs dq_u dq_v dk dv and dp once
    n_bytes = 10 * b * h * t * dk * sz + 2 * h * (2 * t - 1) * dk * sz + b * t + b * h * t * 4
    bms, by = bound_ms(n_bytes, 8 * 2 * b * h * t * t * dk, dtype)
    print(f"rel_attention_bwd B{b} H{h} T{t} bf16: kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (SDPA backward, float bias mask) bound_ms {bms:.4f} ({by})",
          flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def phase_attention_bwd(ra, dev) -> tuple[dict, dict]:
    """Both backward kernels against their plain versions and autograd
    through the dense forward; times at the training shape."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(5)
    names = {"shear": ("dq_u", "dq_v", "dk", "dv", "dp"), "bias": ("dq_u", "dk", "dv", "dbias")}
    worst = {"shear": 0.0, "bias": 0.0}
    failures = []
    for t, b, h in ((235, 4, 8), (470, 4, 8), (TRAIN_SHAPE[2],) + TRAIN_SHAPE[:2]):
        for dtype in (torch.float32, torch.bfloat16):
            (q_u, q_v, k, v, p), mask, g = bwd_inputs(gen, b, h, t, dtype, dev)
            tol = bwd_tolerance(dtype)
            dname = str(dtype).replace("torch.", "")
            # shear route
            out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
            got = ra.rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g)
            f32 = [x.float() for x in (q_u, q_v, k, v, p)]
            plain = ra.rel_attention_bwd_plain(*f32, mask, lse, out.float(), g.float())
            auto = autograd_ref(lambda *a: ra.dense_rel_attention(*a, mask), f32, g)
            # bias route on the same inputs
            bias = ra.rel_position_bias(q_v, p)
            out_b, lse_b = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)
            got_b = ra.rel_attention_bias_bwd_kernel(q_u, k, v, bias, mask, lse_b, out_b, g)
            qkv = [f32[0], f32[2], f32[3]]
            plain_b = ra.bias_attention_bwd_plain(*qkv, bias, mask, lse_b, out_b.float(), g.float())
            auto_b = autograd_ref(lambda a, b_, c, d: ra.dense_bias_attention(a, b_, c, d, mask),
                                  qkv + [bias], g)
            torch.cuda.synchronize()
            for route, grads, refs in (("shear", got, (plain, auto)), ("bias", got_b, (plain_b, auto_b))):
                e_plain, e_auto = grad_errs(grads, refs[0]), grad_errs(grads, refs[1])
                masked_row = max(float(x[2].float().abs().max()) for x in grads[:4])
                finite = all(bool(torch.isfinite(x.float()).all()) for x in grads)
                ok = max(e_plain + e_auto) <= tol and masked_row == 0.0 and finite
                worst[route] = max(worst[route], *e_plain) if dtype == torch.bfloat16 else worst[route]
                line = (f"rel_attention{'_bias' if route == 'bias' else ''}_bwd B{b} H{h} T{t} {dname}: "
                        f"max err / max(1,|ref|) vs plain {dict(zip(names[route], (f'{e:.2e}' for e in e_plain)))} "
                        f"vs autograd {max(e_auto):.2e} (tol {tol:g}); fully masked batch row max |grad| "
                        f"{masked_row:g}; |dv| max {float(grads[-2 if route == 'bias' else 3].float().abs().max()):.3f} "
                        f"finite {finite}")
                if route == "bias":
                    e_db, faults = dbias_errs(grads[3], refs[0][3]), dbias_faults(grads[3], refs[0][3])
                    ok = ok and dbias_ok(e_db) and not any(dbias_ok(e) for e in faults.values())
                    line += (f"; dbias vs plain {fmt_errs(e_db)} (tol max {DBIAS_TOL['max']:g} rms "
                             f"{DBIAS_TOL['rms']:g}), faulty dbias: dS in bf16 {fmt_errs(faults['bf16'])}, "
                             f"entries under 1% lost {fmt_errs(faults['small_lost'])}")
                print(line, flush=True)
                if not ok:
                    failures.append(line)
            del plain, auto, plain_b, auto_b, got, got_b, bias
            torch.cuda.empty_cache()
    if failures:
        fail("a backward kernel disagrees with its plain version")

    # times at the serving shape and at the training shape, bf16, all keys valid
    serving = shear_bwd_times(ra, gen, dev, 4, 8, 480)
    shear = {"max_abs_err": worst["shear"], **shear_bwd_times(ra, gen, dev, *TRAIN_SHAPE),
             "serving_shape": serving}
    bias_serving = bias_bwd_times(ra, gen, dev, 4, 8, 480, serving["ms"])
    bias_res = {"max_abs_err": worst["bias"], **bias_bwd_times(ra, gen, dev, *TRAIN_SHAPE, shear["ms"]),
                "serving_shape": bias_serving}
    return shear, bias_res


def bias_bwd_times(ra, gen, dev, b, h, t, shear_ms: float) -> dict:
    """Kernel 5 (bf16, all keys valid) beside its bound, its plain version,
    the backward of SDPA with the same bias as a float mask, and the autograd
    of the bias construction that follows it in the route."""
    dtype, dk, sz = torch.bfloat16, 64, 2
    (q_u, q_v, k, v, p), _, g = bwd_inputs(gen, b, h, t, dtype, dev)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    bias = ra.rel_position_bias(q_v, p)
    out, lse = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)
    iters = 20 if t < 1000 else 5
    k_ms = time_ms(lambda: ra.rel_attention_bias_bwd_kernel(q_u, k, v, bias, mask, lse, out, g),
                   iters=iters)
    plain_ms = time_ms(lambda: ra.bias_attention_bwd_plain(q_u, k, v, bias, mask, lse, out, g),
                       iters=3)
    lib_ms = sdpa_bwd_ms(q_u, k, v, bias.to(dtype), g)
    dbias = ra.rel_attention_bias_bwd_kernel(q_u, k, v, bias, mask, lse, out, g)[3]
    qv_leaf, p_leaf = q_v.detach().requires_grad_(), p.detach().requires_grad_()
    bias_leaf = ra.rel_position_bias(qv_leaf, p_leaf)
    bias_bwd_ms = time_ms(lambda: torch.autograd.grad(bias_leaf, (qv_leaf, p_leaf), dbias,
                                                      retain_graph=True), iters=5)
    # inputs q_u k v out dO, bias, mask, lse once; outputs dq_u dk dv and dbias once
    n_bytes = 8 * b * h * t * dk * sz + 2 * 4 * b * h * t * t + b * t + b * h * t * 4
    bounds = both_bounds_ms(n_bytes, 5 * 2 * b * h * t * t * dk, dtype)
    print(f"rel_attention_bias_bwd B{b} H{h} T{t} bf16: kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (SDPA backward, the same bias) bound_ms {bounds['bound_ms']:.4f} "
          f"({bounds['bound_by']}; bytes {bounds['bytes_bound_ms']:.4f}, operations "
          f"{bounds['operations_bound_ms']:.4f}); autograd of rel_position_bias {bias_bwd_ms:.4f} ms: "
          f"bias route backward {k_ms + bias_bwd_ms:.4f} ms | shear route backward {shear_ms:.4f} ms",
          flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms, **bounds,
            "bias_autograd_ms": bias_bwd_ms}


def phase_dropout(ra, dm, dev) -> dict:
    """In-kernel dropout of the four rel-attention kernels, forward and
    backward against the plain versions under the identical keep mask: at
    B4 H8 T235 in f32 and bf16, and at the configuration the train step
    launches them with (B8 H8 T1200 bf16, rate 0.1, ragged, a seed of 31
    bits). Returns the four kernels' times at the training shape with dropout
    0.1."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(6)
    failures = []
    cases = [(4, 8, 235, torch.float32, (0.1, 0.3), 1000),
             (4, 8, 235, torch.bfloat16, (0.1, 0.3), 1000),
             TRAIN_SHAPE + (torch.bfloat16, (0.1,), 1234567891)]
    for b, h, t, dtype, rates, seed0 in cases:
        fwd_tol = 1e-4 if dtype == torch.float32 else 2e-2
        tol = bwd_tolerance(dtype)
        dname = str(dtype).replace("torch.", "")
        (q_u, q_v, k, v, p), mask, g = bwd_inputs(gen, b, h, t, dtype, dev)
        lens = [int(n) for n in mask.sum(1)]
        f32 = [x.float() for x in (q_u, q_v, k, v, p)]
        bias = ra.rel_position_bias(q_v, p)
        for rate in rates:
            seed = seed0 + int(rate * 10)
            keep = dm.attention_keep_mask(seed, rate, b, h, t, dev)
            out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask, rate, seed)
            ref = ra.dense_rel_attention(*f32, mask, keep, rate)
            got = ra.rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g, rate, seed)
            plain = ra.rel_attention_bwd_plain(*f32, mask, lse, out.float(), g.float(), keep, rate)
            out_b, lse_b = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask, rate, seed)
            ref_b = ra.dense_bias_attention(f32[0], f32[2], f32[3], bias, mask, keep, rate)
            got_b = ra.rel_attention_bias_bwd_kernel(q_u, k, v, bias, mask, lse_b, out_b, g, rate, seed)
            plain_b = ra.bias_attention_bwd_plain(f32[0], f32[2], f32[3], bias, mask, lse_b,
                                                  out_b.float(), g.float(), keep, rate)
            torch.cuda.synchronize()
            for route, o, r, gr, pl in (("shear", out, ref, got, plain), ("bias", out_b, ref_b, got_b, plain_b)):
                e_out, e_grad = valid_rows_err(o, r, lens), max(grad_errs(gr, pl))
                line = (f"dropout {route} B{b} H{h} T{t} {dname} rate {rate}: forward max_abs_err "
                        f"{e_out:.3e} (tol {fwd_tol:g}) backward max err / max(1,|ref|) {e_grad:.3e} "
                        f"(tol {tol:g}), identical keep mask")
                ok = e_out <= fwd_tol and e_grad <= tol
                if route == "bias":
                    e_db = dbias_errs(gr[3], pl[3])
                    ok = ok and dbias_ok(e_db)
                    line += (f"; dbias {fmt_errs(e_db)} (tol max {DBIAS_TOL['max']:g} "
                             f"rms {DBIAS_TOL['rms']:g})")
                print(line, flush=True)
                if not ok:
                    failures.append(line)
            del keep, ref, ref_b, plain, plain_b, got, got_b
        del bias, f32
        torch.cuda.empty_cache()
    # the kernel's own mask: with T = 64 and V = I the output is P~ itself
    # (f32 and bf16: the two types run different shear kernels)
    b, h, t = 2, 8, 64
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
        q_u, q_v, k = (0.3 * mk(b, h, t, 64) for _ in range(3))
        v = torch.eye(64, device=dev, dtype=dtype).expand(b, h, 64, 64).contiguous()
        p = 0.3 * mk(h, 2 * t - 1, 64)
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        for rate in (0.1, 0.3):
            n = b * h * t * t
            sigma = math.sqrt(rate * (1 - rate) / n)
            for route in ("shear", "bias"):
                if route == "shear":
                    out = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask, rate, 77)[0]
                else:
                    out = ra.rel_attention_bias_kernel(q_u, k, v, ra.rel_position_bias(q_v, p), mask,
                                                       rate, 77)[0]
                kept = out != 0
                same = bool((kept == dm.attention_keep_mask(77, rate, b, h, t, dev)).all())
                frac = float(kept.float().mean())
                line = (f"dropout {route} mask {dname}, rate {rate}: equals ops/dropout_mask.py {same}; "
                        f"keep rate {frac:.5f} vs {1 - rate} (3 sigma {3 * sigma:.5f}, {n} elements)")
                print(line, flush=True)
                if not (same and abs(frac - (1 - rate)) <= 3 * sigma):
                    failures.append(line)
    # determinism and unbiasedness (B1 H2 T128, rate 0.3, 48 seeds)
    b, h, t = 1, 2, 128
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
        q_u, q_v, k, v = (mk(b, h, t, 64) for _ in range(4))
        p = mk(h, 2 * t - 1, 64)
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        for route in ("shear", "bias"):
            if route == "shear":
                f = lambda seed, rate: ra.rel_attention_kernel(q_u, q_v, k, v, p, mask, rate, seed)[0].float()  # noqa: E731
            else:
                bias = ra.rel_position_bias(q_v, p)
                f = lambda seed, rate: ra.rel_attention_bias_kernel(q_u, k, v, bias, mask, rate, seed)[0].float()  # noqa: E731
            base, a1, a1b, a2 = f(0, 0.0), f(1, 0.3), f(1, 0.3), f(2, 0.3)
            mean = sum(f(100 + s, 0.3) for s in range(48)) / 48
            rel = float((mean - base).abs().mean() / base.abs().mean())
            ok = (torch.equal(a1, a1b) and not torch.allclose(a1, a2)
                  and not torch.allclose(a1, base, atol=1e-3) and rel < 0.2)
            line = (f"dropout {route} {dname} rate 0.3: same seed equal {torch.equal(a1, a1b)}, other seed "
                    f"differs {not torch.allclose(a1, a2)}, mean of 48 seeds vs no dropout rel err "
                    f"{rel:.4f} (< 0.2)")
            print(line, flush=True)
            if not ok:
                failures.append(line)
    if failures:
        fail("in-kernel dropout disagrees with its plain version")
    # forward times with dropout on, at the training shape
    b, h, t = TRAIN_SHAPE
    (q_u, q_v, k, v, p), _, g = bwd_inputs(gen, b, h, t, torch.bfloat16, dev)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    bias = ra.rel_position_bias(q_v, p)
    times = {}
    for rate in (0.0, 0.1):
        out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask, rate, 5)
        out_b, lse_b = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask, rate, 5)
        times[rate] = {
            "rel_attention": time_ms(lambda: ra.rel_attention_kernel(q_u, q_v, k, v, p, mask, rate, 5), iters=5),
            "rel_attention_bwd": time_ms(lambda: ra.rel_attention_bwd_kernel(
                q_u, q_v, k, v, p, mask, lse, out, g, rate, 5), iters=5),
            "rel_attention_bias": time_ms(lambda: ra.rel_attention_bias_kernel(
                q_u, k, v, bias, mask, rate, 5), iters=5),
            "rel_attention_bias_bwd": time_ms(lambda: ra.rel_attention_bias_bwd_kernel(
                q_u, k, v, bias, mask, lse_b, out_b, g, rate, 5), iters=5)}
    build_ms = time_ms(lambda: ra.rel_position_bias(q_v, p), iters=5)
    print(f"B{b} H{h} T{t} bf16 kernel_ms without dropout {times[0.0]} | with dropout 0.1 "
          f"{times[0.1]}; rel_position_bias forward {build_ms:.4f} ms", flush=True)
    return times[0.1]


def train_batch(cfg, accum: int, b: int, frames: int, seed: int) -> dict:
    """A ragged synthetic stage-1 batch in the (accum, B, ...) layout: uint8
    video, unit tokens with eos then pad, random mel targets."""
    rng = np.random.default_rng(seed)
    size, units = cfg.video.mouth_size, cfg.model.units
    lens = np.maximum(1, (frames * np.linspace(1.0, 0.5, b)).astype(int))
    lens = np.stack([np.roll(lens, i) for i in range(accum)])            # (accum, B)
    tok = rng.integers(units.num_special, units.vocab_size, (accum, b, 2 * frames + 1))
    pos = np.arange(2 * frames + 1)[None, None, :]
    tok = np.where(pos < 2 * lens[..., None], tok, units.pad)
    tok = np.where(pos == 2 * lens[..., None], units.eos, tok)
    return {"video": rng.integers(0, 256, (accum, b, frames, size, size, 1), dtype=np.uint8),
            "frames_mask": np.arange(frames)[None, None, :] < lens[..., None],
            "spk_emb": rng.standard_normal((accum, b, cfg.model.spk_emb_dim)).astype(np.float32),
            "unit_tokens": tok,
            "mel": rng.standard_normal((accum, b, 4 * frames, cfg.model.mel_dim)).astype(np.float32)}


def counted_step(counters: dict, step, state, batch, expected: dict, what: str):
    """One optimizer step with every launch count set to 0 just before and
    read just after; returns (logs as floats, wall ms, counts)."""
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, logs = step(state, batch)
    logs = {k: float(v) for k, v in logs.items()}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {name: c.launches for name, c in counters.items()}
    want = {name: expected.get(name, 0) for name in counters}
    print(f"{what}: step_ms {ms:.1f} launches {counts} loss/sample "
          f"{logs['loss'] / max(logs['sample_size'], 1):.4f} nll/token "
          f"{logs['nll_loss'] / max(logs['total'], 1):.4f} mel_loss {logs['mel_loss']:.4f} "
          f"sample_size {logs['sample_size']:.0f} grad_norm {logs['grad_norm']:.4f}", flush=True)
    if counts != want:
        fail(f"{what}: expected launches {want}, got {counts}")
    if not all(math.isfinite(v) for v in logs.values()):
        fail(f"{what}: non-finite logs {logs}")
    return logs, ms, counts


def phase_train(s1, counters: dict, preset) -> dict:
    """Stage-1 training of multi_target at full width on the card. Returns
    the launch counts of one optimizer step (both routes)."""
    set_tf32(True)                                  # bf16 compute; TF32 only touches f32 leftovers
    base = preset("multi_target")
    accum = 2
    cfg = dataclasses.replace(base, stage1=dataclasses.replace(
        base.stage1, warmup_updates=2, max_updates=10, update_freq=accum, bf16_compute=True))
    layers = cfg.model.conformer.layers
    t0 = time.perf_counter()
    state = s1.create_train_state(cfg, seed=0)
    step = s1.make_train_step(cfg)
    n_params = sum(p.numel() for p in state.model.parameters())
    before = [p.detach().clone() for p in s1.trained_parameters(state.model)]
    print(f"train multi_target: init s {time.perf_counter() - t0:.1f} parameters {n_params / 1e6:.1f} M "
          f"(dropout {cfg.model.conformer.dropout}, attention dropout "
          f"{cfg.model.conformer.attention_dropout}, bf16 compute, accumulation {accum})", flush=True)
    expected = {"rel_attention": layers * accum, "rel_attention_bwd": layers * accum}
    frames = None
    for cand in (cfg.stage1.max_sample_size, 480, 360, 240):
        batch = train_batch(cfg, accum, cfg.stage1.batch_size, cand, seed=0)
        torch.cuda.reset_peak_memory_stats()
        try:
            logs1, ms1, counts = counted_step(counters, step, state, batch, expected,
                                              f"train multi_target 8x{cand} step 1")
        except torch.cuda.OutOfMemoryError:
            print(f"train multi_target: micro-batch 8 x {cand} frames does not fit", flush=True)
            state.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            if state.step != 0:
                fail("out of memory after the update began")
            continue
        frames = cand
        break
    if frames is None:
        fail("no micro-batch size fits the card")
    what = f"train multi_target 8x{frames}"
    logs, times = [logs1], [ms1]
    for i in (2, 3):
        lg, ms, _ = counted_step(counters, step, state, batch, expected, f"{what} step {i}")
        logs.append(lg)
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = max(float((p.detach() - b_).abs().max()) for p, b_ in zip(s1.trained_parameters(state.model), before))
    per_sample = [lg["loss"] / lg["sample_size"] for lg in logs]
    print(f"{what}: step_ms {[round(t, 1) for t in times]} p50 {float(np.median(times)):.1f}; "
          f"peak memory {peak:.2f} GiB; parameters moved by up to {moved:.3e}; loss/sample "
          f"{[round(x, 4) for x in per_sample]} (same batch)", flush=True)
    if not (moved > 0 and per_sample[2] < per_sample[0] and state.step == 3):
        fail(f"{what}: parameters did not move or the loss did not fall")
    profile_call(lambda: step(state, batch), f"{what} shear", top=20)
    bias_expected = {"rel_attention_bias": layers * accum, "rel_attention_bias_bwd": layers * accum}
    with flash_impl("bias"):
        torch.cuda.reset_peak_memory_stats()
        _, _, bias_counts = counted_step(counters, step, state, batch, bias_expected,
                                         f"{what} impl=bias step 5")
        print(f"{what} impl=bias: peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        profile_call(lambda: step(state, batch), f"{what} bias", top=6)
    del state, step, before
    torch.cuda.empty_cache()
    return {**{k: counts[k] for k in expected}, **{k: bias_counts[k] for k in bias_expected}}


def phase_train_f32_check(s1, preset) -> None:
    """f32, TF32 off, dropout 0, the recipe's optimizer (Adam eps 1e-8): two
    optimizer steps of the full-width multi_target on the card (kernel path)
    against the same weights on the CPU (plain path), two different batches
    of 2 x 32 frames, accumulation 2. The first update runs at rate 0 and
    the second at 1e-3.

    The model is piecewise linear with random weights, so its gradient is
    not a continuous function of rounding: among its ~10^8 ReLU inputs a few
    lie within rounding of 0, and a gate that opens on one device only moves
    the gradients behind it by one position's share. The yardstick for that
    is measured here, not assumed: a twin of the CPU run whose weights are
    moved by about one unit in the last place (times 1 + 1e-7 * normal
    noise) is compared with the CPU run in the same way as the card is.

    Compared:
    - loss and grad_norm of both steps, 1e-4 relative (sums in another order);
    - BatchNorm running statistics (they never see an updated weight here),
      5e-5 of max(1, a tensor's largest magnitude);
    - the first step's divided gradients by parameter name, read back from
      Adam's first moment (exp_avg = (1 - b1) * g after one step, g after
      the clip): every tensor's error in the 2-norm over the whole gradient's
      2-norm, 1e-4, and every element over the step's largest gradient
      element, 1e-4 (as the CPU test against JAX);
    - updated parameters, 5e-5 absolute (a twentieth of the one non-zero
      step), on the elements whose gradient history stands above rounding:
      r = sqrt(exp_avg_sq / (1 - b2^2)) of the CPU run at least a tenth of
      its tensor's largest r, in tensors whose largest r is at least 1e-4
      of the model's largest. Adam divides by sqrt(v): an element whose
      gradient is zero in exact arithmetic (a bias in front of a BatchNorm,
      the key bias under the softmax) or far below its tensor's scale is
      rounding noise on either device, and the update turns the noise's
      sign into a step of the full rate. Those elements are shown, not
      compared: the worst error per decade of r below its tensor's largest,
      and the tensor with the worst error among those left out whole.
    Each of the last three passes if it is within its tolerance or within
    ten times what the twin reads."""
    set_tf32(False)
    base = preset("multi_target")
    conf = dataclasses.replace(base.model.conformer, dropout=0.0, attention_dropout=0.0)
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, conformer=conf, final_dropout=0.0),
        stage1=dataclasses.replace(base.stage1, warmup_updates=1, max_updates=10, update_freq=2))
    b1, b2 = cfg.stage1.adam_b1, cfg.stage1.adam_b2
    step = s1.make_train_step(cfg)
    batches = [train_batch(cfg, 2, 2, 32, seed=seed) for seed in (3, 4)]

    def moments(state, key):
        # a copy: the optimizer updates its moments in place
        return {n: state.optimizer.state[p][key].detach().to("cpu", copy=True)
                for n, p in state.model.named_parameters() if p.requires_grad}

    def two_steps(state):
        """logs of both steps, the first step's gradients, the final state."""
        logs = []
        for i, batch in enumerate(batches):
            logs.append({k: float(v) for k, v in step(state, batch)[1].items()})
            if i == 0:
                grads = {n: m / (1 - b1) for n, m in moments(state, "exp_avg").items()}
        return logs, grads, {k: v.cpu() for k, v in state.model.state_dict().items()}

    cpu = s1.create_train_state(cfg, seed=0, device="cpu")
    start = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    noise = torch.Generator().manual_seed(1)
    moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=noise)) if k.endswith(("weight", "bias"))
             else v for k, v in start.items()}
    ref_logs, g_ref, sd_ref = two_steps(cpu)
    runs = {"card": two_steps(s1.create_train_state(cfg, device="cuda", state_dict=start)),
            "twin": two_steps(s1.create_train_state(cfg, device="cpu", state_dict=moved))}
    names = list(g_ref)
    g_max = max(float(g.abs().max()) for g in g_ref.values())
    g_norm = math.sqrt(sum(float(g.square().sum()) for g in g_ref.values()))
    r = {n: (v / (1 - b2 ** 2)).sqrt() for n, v in moments(cpu, "exp_avg_sq").items()}
    r_max = max(float(x.max()) for x in r.values())
    stats = [k for k in sd_ref if k.endswith(("running_mean", "running_var"))]
    decades = list(range(-1, -10, -1))               # r / its tensor's largest in [10^d, 10^(d+1))
    what = ("train multi_target f32 (2 steps, 2 x 32 frames, accumulation 2, dropout 0, Adam eps 1e-8) "
            "against the plain path on the CPU")
    print(f"{what}: loss {ref_logs[1]['loss']:.3f} grad_norm {ref_logs[1]['grad_norm']:.3f}; largest "
          f"gradient element {g_max:.3e}, {len(names)} tensors", flush=True)

    def worst_of(errs: dict) -> tuple[float, str]:
        key = max(errs, key=errs.get)
        return errs[key], key

    read = {}
    for who, (logs, grads, sd) in runs.items():
        if who == "twin":                            # the twin started a last place away
            sd = {k: v - (moved[k] - start[k]) for k, v in sd.items()}
        rel = {k: max(abs(lg[k] - rl[k]) / abs(rl[k]) for lg, rl in zip(logs, ref_logs))
               for k in ("loss", "grad_norm")}
        stat = worst_of({k: float((sd[k] - sd_ref[k]).abs().max()) / max(1.0, float(sd_ref[k].abs().max()))
                         for k in stats})
        l2 = worst_of({n: float(torch.linalg.vector_norm(grads[n] - g_ref[n])) / g_norm for n in names})
        elem = worst_of({n: float((grads[n] - g_ref[n]).abs().max()) / g_max for n in names})
        by_decade = {d: [0, 0.0, ""] for d in decades}       # elements, worst error, its tensor
        n_in = n_all = 0
        par, left_out = (0.0, ""), (0.0, "", 0.0)
        for n in names:
            err = (sd[n] - sd_ref[n]).abs()
            leaf_max = float(r[n].max())
            n_all += err.numel()
            if leaf_max < 1e-4 * r_max:                  # a tensor left out whole
                if float(err.max()) >= left_out[0]:
                    left_out = (float(err.max()), n, leaf_max / r_max)
                continue
            inside = r[n] >= 0.1 * leaf_max
            n_in += int(inside.sum())
            if float(err[inside].max()) >= par[0]:
                par = (float(err[inside].max()), n)
            dec = torch.floor(torch.log10((r[n] / leaf_max).clamp(min=1e-30))).clamp(-9, -1).long()
            for d in decades:
                sel = dec == d
                if bool(sel.any()):
                    by_decade[d][0] += int(sel.sum())
                    if float(err[sel].max()) >= by_decade[d][1]:
                        by_decade[d][1:] = [float(err[sel].max()), n]
        read[who] = {"rel": rel, "stat": stat, "l2": l2, "elem": elem, "par": par, "n_in": n_in}
        print(f"{what}, {who}: relative err {rel} (tol 1e-4); running statistics max err / max(1,|ref|) "
              f"{stat[0]:.3e} at {stat[1]} (tol 5e-5)", flush=True)
        print(f"{what}, {who}: first-step gradients by name: worst 2-norm of a tensor's error / 2-norm "
              f"of the gradient {l2[0]:.3e} at {l2[1]} (tol 1e-4); worst max err / largest gradient "
              f"element {elem[0]:.3e} at {elem[1]} (tol 1e-4)", flush=True)
        print(f"{what}, {who}: updated parameters on {n_in} of {n_all} elements with gradient history "
              f"r >= 0.1 of their tensor's largest: max abs err {par[0]:.3e} at {par[1]} (tol 5e-5); "
              f"worst tensor left out whole {left_out[0]:.3e} at {left_out[1]} (its largest r / the "
              f"model's largest {left_out[2]:.1e})", flush=True)
        for d in decades:
            span = f"[1e{d}, 1e{d + 1})" if d > decades[-1] else f"< 1e{d + 1}"
            print(f"{what}, {who}:   r / its tensor's largest r {span}: {by_decade[d][0]:>10d} elements, "
                  f"max abs parameter err {by_decade[d][1]:.3e} at {by_decade[d][2]}", flush=True)
    card, twin = read["card"], read["twin"]
    ok = (max(card["rel"].values()) <= 1e-4 and card["stat"][0] <= 5e-5
          and card["n_in"] >= sum(g.numel() for g in g_ref.values()) // 100
          and all(card[k][0] <= max(tol, 10 * twin[k][0])
                  for k, tol in (("l2", 1e-4), ("elem", 1e-4), ("par", 5e-5))))
    print(f"{what}: card / twin: gradient 2-norm {card['l2'][0]:.3e} / {twin['l2'][0]:.3e}, gradient "
          f"element {card['elem'][0]:.3e} / {twin['elem'][0]:.3e}, parameters {card['par'][0]:.3e} / "
          f"{twin['par'][0]:.3e} (each passes within its tolerance or ten times the twin's)", flush=True)
    if not ok:
        fail("f32 training on the kernel path disagrees with the CPU plain path")


def phase_train_flagship(s1, counters: dict, preset) -> dict:
    """One optimizer step of multi_target_avhubert at full width: the frozen
    frontend takes no gradient and no update."""
    set_tf32(True)
    base = preset("multi_target_avhubert")
    accum = 2
    cfg = dataclasses.replace(base, stage1=dataclasses.replace(
        base.stage1, warmup_updates=1, max_updates=10, update_freq=accum, bf16_compute=True))
    state = s1.create_train_state(cfg, seed=0)
    step = s1.make_train_step(cfg)
    frontend = {k: v.detach().clone() for k, v in state.model.state_dict().items()
                if k.startswith("frontend")}
    batch = train_batch(cfg, accum, cfg.stage1.batch_size, cfg.stage1.max_sample_size, seed=1)
    layers = cfg.model.conformer.layers
    expected = {"attention": cfg.model.frontend.encoder_layers * accum,
                "rel_attention": layers * accum, "rel_attention_bwd": layers * accum}
    torch.cuda.reset_peak_memory_stats()
    counted_step(counters, step, state, batch, expected, "train multi_target_avhubert 8x600 step 1")
    _, _, counts = counted_step(counters, step, state, batch, expected,
                                "train multi_target_avhubert 8x600 step 2")
    sd = state.model.state_dict()
    unchanged = all(torch.equal(sd[k], v) for k, v in frontend.items())
    no_grad = all(not p.requires_grad and p.grad is None
                  for m in state.model.frontend_modules() for p in m.parameters())
    n_frozen = sum(p.numel() for m in state.model.frontend_modules() for p in m.parameters())
    print(f"train multi_target_avhubert: frozen frontend ({n_frozen / 1e6:.1f} M parameters) unchanged "
          f"{unchanged}, without gradient {no_grad}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    if not (unchanged and no_grad):
        fail("the frozen frontend was updated")
    del state, step
    torch.cuda.empty_cache()
    return counts


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
    from lip2speech_tpu_torch.ops import dropout_mask as dm
    from lip2speech_tpu_torch.ops import fused_tail as ft
    from lip2speech_tpu_torch.ops import kmeans as km
    from lip2speech_tpu_torch.ops import rel_attention as ra
    from lip2speech_tpu_torch.pipeline import synthesise as syn
    from lip2speech_tpu_torch.pipeline import units_extract as ue
    from lip2speech_tpu_torch.train import stage1 as s1

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {log.stem}: {line.strip()}", flush=True)
    hmma = sass_tensor_core_counts(build)

    counters = {"rel_attention": ra.rel_attention_kernel,
                "rel_attention_bwd": ra.rel_attention_bwd_kernel,
                "rel_attention_bias": ra.rel_attention_bias_kernel,
                "rel_attention_bias_bwd": ra.rel_attention_bias_bwd_kernel,
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
    shear_bwd, bias_bwd = phase_attention_bwd(ra, dev)
    dropout_ms = phase_dropout(ra, dm, dev)
    train_launches = phase_train(s1, counters, preset)
    phase_train_f32_check(s1, preset)
    phase_train_flagship(s1, counters, preset)
    for name, numbers in (("rel_attention", rel), ("rel_attention_bias", bias),
                          ("rel_attention_bwd", shear_bwd), ("rel_attention_bias_bwd", bias_bwd)):
        numbers["dropout"] = "philox.cuh"
        numbers["train_shape_dropout_ms"] = dropout_ms[name]
        numbers["train_step_launches"] = train_launches[name]
    for name, lib, numbers in (("rel_attention", "rel_attention", rel),
                               ("rel_attention_bwd", "rel_attention_bwd", shear_bwd),
                               ("rel_attention_bias", "rel_attention_bias", bias),
                               ("rel_attention_bias_bwd", "rel_attention_bias_bwd", bias_bwd),
                               ("attention", "attention", plain),
                               ("fused_resblock_trio", "fused_tail", trio)):
        numbers.update(design="mma.sync m16n8k16 bf16, f32 accumulate; f32: FMA",
                       hmma_in_sass=hmma[lib])
    launches.update({k: train_launches[k] for k in ("rel_attention_bwd", "rel_attention_bias_bwd")})
    pkg = "lip2speech_tpu_torch"
    jax_ops = "lip2speech_tpu/ops"
    kernels = [
        {"name": name, "route": "cuda", "source": f"{pkg}/csrc/{source}",
         "replaces": f"{jax_ops}/{replaces}", "launches": launches[name], **numbers}
        for name, source, replaces, numbers in (
            ("rel_attention", "rel_attention.cu", "pallas_rel_attention.py:127", rel),
            ("fused_resblock_trio", "fused_tail.cu", "pallas_fused_tail.py:160", trio),
            ("rel_attention_bias", "rel_attention_bias.cu", "pallas_rel_attention.py:521", bias),
            ("attention", "attention.cu", "pallas_attention.py:30", plain),
            ("rel_attention_bwd", "rel_attention_bwd.cu", "pallas_rel_attention.py:180", shear_bwd),
            ("rel_attention_bias_bwd", "rel_attention_bias_bwd.cu", "pallas_rel_attention.py:567",
             bias_bwd))
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
