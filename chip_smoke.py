#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lip2speech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from lip2speech_tpu_torch/csrc (nvcc, in parallel);
     print ptxas's registers and spills of every kernel (each f32 and bf16
     instantiation), and count the tensor-core (HMMA) instructions in each
     library's SASS, the TF32 ones apart: none in any of rel_attention,
     rel_attention_bwd, rel_attention_bias, rel_attention_bias_bwd,
     attention and fused_tail (bf16 on mma.sync), or no TF32 one in any of
     them (f32 in 3xTF32), fails;
  3. rel-position attention kernel against its plain version, f32 and bf16;
     bf16 times at B4 H8 T480 and at the train step's B8 H8 T1200, each
     beside SDPA with the position term as a float bias mask; the f32 path
     (3xTF32) within 1e-4 of its plain version at the f32 request's B1 H8
     T192, B4 H8 T480 and B8 H8 T1200, where the forward at one TF32
     product (rel_attention_one_tf32) must not be, and timed there beside
     f32 SDPA, the plain version, its f32 FMA bound and its 3xTF32 bound;
  4. fused resblock-trio kernel against its plain version, per stage width,
     bf16 and f32 (3xTF32, TRIO_F32_TOL = 2e-5 of max(1, |ref|) with TF32
     off, which the trio at one TF32 product, trio_one_tf32, must fail); each
     stage's time beside its plain version (cuDNN's 18 convs), its bound
     (f32: the FMA and the 3xTF32 bound) and its tile and blocks at the
     batch-4 x 240-frame and batch-1 x 96-frame row counts;
  5. the full-width multi_target pipeline: bf16 + PCM16 requests at batch
     4 x 240 frames (ragged) and 1 x 96, launch counts per forward, p50; then
     the f32 kernel path against the same weights' plain path on the CPU;
  6. masked flash attention kernel against its plain version (the AV-HuBERT
     and HuBERT shapes, a fully masked batch row), f32 and bf16; bf16 times
     at B4 H16 T240 and at the flagship train step's B8 H16 T600, beside SDPA
     and the bound; the f32 path (3xTF32) within ATTENTION_F32_TOL = 3e-5 of
     its plain version in every f32 case, where the attention at one TF32
     product (attention_one_tf32) must not be, and timed at the flagship's
     f32 request B1 H16 T96, B4 H16 T240, unit extraction's B1 H12 T500 and
     a full chunk's B1 H12 T4999 beside f32 SDPA, the plain version, its f32
     FMA bound and its 3xTF32 bound;
  7. bias-flash rel-position attention kernel against its plain version
     (T 480 / 470 ragged, T 470 with a fully masked batch row; f32 and
     bf16), and its time plus the bias construction beside the shear kernel
     of phase 3; bf16 times at B4 H8 T480 and at the train step's B8 H8
     T1200, each beside its plain version, SDPA with the same bias and the
     bound (bytes and operations); the f32 path (3xTF32) within 1e-4 of its
     plain version in every f32 case and at B4 H8 T480 and B8 H8 T1200
     (ragged, a fully masked batch row), where the forward at one TF32
     product (bias_attention_one_tf32) must not be, and timed there beside
     f32 SDPA with the same bias, the plain version, its f32 FMA bound and
     its 3xTF32 bound;
  8. the full-width multi_target_avhubert pipeline as in 5, with both
     rel-attention implementations (LIP2SPEECH_FLASH_IMPL shear | bias), and
     multi_target's batch-4 p50 under both; then its f32 request (the
     server's default dtype, TF32 off) at B1 x 96 and B4 x 240: exact launch
     counts (24 attention), p50, device busy ms and the attention kernel's
     share;
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
     beside the autograd of the bias construction; the shear backward's f32
     path (3xTF32) at B4 H8 T480 and B8 H8 T1200 within 1e-4 of max(1,
     |ref|) of its plain version, where the backward at one TF32 product
     (rel_attention_bwd_one_tf32) must not be, and timed there beside f32
     SDPA's backward, the plain version and both bounds; the bias route's
     f32 backward (3xTF32) at the same shapes within 1e-4 of max(1, |ref|)
     a gradient and DBIAS_TOL, where the backward at one TF32 product
     (bias_attention_bwd_one_tf32) must not be, and timed there beside f32
     SDPA's backward with the same bias, the plain version and both bounds;
 12. in-kernel attention dropout, both routes, forward and backward, against
     the plain versions under the identical keep mask (dbias by DBIAS_TOL);
     the kernel's mask against ops/dropout_mask.py; determinism, keep rate,
     unbiasedness;
 13. stage-1 training of multi_target at full width (no depth cut): bf16
     compute, dropout 0.1, micro-batch 8 x 600 frames, accumulation 2, three
     optimizer steps with exact launch counts, one profiled step, one step
     with the bias route; then the f32 step as the train_stage1 CLI runs it
     (the same recipe with bf16_compute off, TF32 in cuDNN only): three
     steps with exact launch counts, p50, peak memory and a profiled step
     with the rel-attention kernels' share, then the same under the bias
     route (rel_attention_bias and rel_attention_bias_bwd 24 launches a
     step), with the bias construction's forward and autograd beside the
     kernels; then two f32 steps at 2 x 32
     frames on the card against the CPU plain path; then one step of the
     flagship multi_target_avhubert (frozen frontend: no gradient, no
     update);
 14. the trio's f32 path at the stage-2 GAN shapes (B16 x one 8,960-sample
     segment: C128 M1,120 ... C16 M8,960) against its plain version at
     TRIO_F32_TOL (which trio_one_tf32 must fail), timed
     beside it, the f32 FMA operations bound and the 3xTF32 bound;
 15. TrioFn: under grad fused_resblock_trio launches the kernel once and its
     gradients (x, weight_v, weight_g, bias) match autograd through the
     plain trio;
 16. stage-2 GAN training at full width (multi_target's vocoder, MPD, MSD),
     16 x 8,960 samples, f32: three steps with exactly 4 trio launches each,
     p50, peak memory, one profiled step, validation_mel_l1; for comparison
     three steps and a profiled one with the trio stages on the plain trio;
 17. two f32 GAN steps at B2 on the card against the CPU plain path (logs,
     gradients by name, parameters, the spectral u) at fixed limits, and
     three faulty TrioFn backwards that must fail the same check;
 18. the command-line tools at the full width of multi_target, in a
     temporary directory, on a mini dataset of 8 clips (48-120 frames)
     written with the port's writers: train_stage1 (2 updates of 2 x 4
     clips, then --resume to 3 from a file whose noise generators are of
     the other kind or absent, as a converted JAX run's; rel_attention and
     rel_attention_bwd 24 launches an update) and a bitwise restore of
     s1_00000002 into a fresh state; infer from s1_00000003 (12
     rel_attention launches a batch, f32) against the same call on the CPU,
     the mels at CLI_REL_TOL, which a rel_attention 0.1% off must fail;
     synthesise_file in bf16 with a random vocoder (trio x4); train_stage2
     (one epoch of 2 steps at batch 4, then --resume for a second; trio x4
     a step); vocode of two clips from the last g_ (trio x4 an utterance,
     f32) against the CPU, the float waveforms at CLI_REL_TOL, which a trio
     0.1% off must fail;
 19. the serving process (pipeline/server.py) on a thread of this process,
     spoken to over HTTP: full-width multi_target, pipelines "f32" (the
     server's default dtype, TF32 off) and "bf16"; /health names the card;
     /synthesise B1 x 96 in both dtypes (?cid=, then /load_checkpoint),
     exactly 12 rel_attention and 4 trio launches, PCM16 within 1 step of
     the direct _synthesise_frames call; /vsg/synthesise of 750 frames (two
     segments: 24 + 8 launches), again from /dzupload chunks sent last
     first; /vocode from the direct call's units and mel (4 trio launches)
     against pipeline.vocode; --batcher: 4 concurrent requests of 96/90/80/61
     frames in one device call (12 + 4 launches), each within 2 PCM16 steps
     of its unbatched response; the raw-video path (default_landmarker on a
     synthetic 96-px face, warp_crop_batch on the card against the CPU and
     the host crop, embed_utterance and preprocess_audio on the card against
     the CPU, one request with a speaker wav and post-processing); p50 of 10
     HTTP requests beside the direct call's p50 and device busy ms (bf16 and
     f32, with the two kernels' share); a bad video_path gives 400 and the
     next request 200. Prints one "serving" JSON line.
Kernel times are device time (CUDA events, host enqueue hidden behind a
device sleep). Prints one JSON line of per-kernel numbers, then, last,
{"ok": true, "device": {...}}. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,            # FP32, CUDA cores
              torch.bfloat16: 989e12}          # BF16 dense, tensor cores
TF32_FLOPS = 494.7e12                          # TF32 dense, tensor cores
MAIN_LENS = (240, 200, 150, 97)                # batch-4 request lengths
TRAIN_SHAPE = (8, 8, 1200)     # B, H, T of the recipe: 8 x 600 frames, 2 tokens a frame


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


def tf32x3_bound_ms(n_bytes: float, flops: float) -> float:
    """The bound of an f32 function computed in 3xTF32: three TF32 products
    for each f32 one, at the dense TF32 peak (or the bytes, if more)."""
    return max(n_bytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS) * 1e3


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


# libraries whose bf16 path runs on mma.sync, and those whose f32 path runs
# on mma.sync in 3xTF32: all six
TENSOR_CORE_KERNELS = ("rel_attention", "rel_attention_bwd", "rel_attention_bias",
                       "rel_attention_bias_bwd", "attention", "fused_tail")
TF32_KERNELS = TENSOR_CORE_KERNELS


def sass_tensor_core_counts(build) -> tuple[dict, dict]:
    """HMMA instructions in each kernel library's SASS (cuobjdump), all of
    them and the TF32 ones (HMMA.1688.F32.TF32) apart; fails if a library
    whose bf16 path runs on mma.sync has none, or one whose f32 path runs in
    3xTF32 has no TF32 one."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    counts, tf32 = {}, {}
    for lib in sorted(build._build_dir().glob("lib*.so")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        hmma = [line for line in sass.splitlines() if "HMMA" in line]
        counts[lib.stem[3:]] = len(hmma)
        tf32[lib.stem[3:]] = sum(1 for line in hmma if "TF32" in line)
    print(f"SASS HMMA instructions per library: {counts}; of them TF32: {tf32}", flush=True)
    missing = [k for k in TENSOR_CORE_KERNELS if not counts.get(k)]
    missing += [f"{k} (TF32)" for k in TF32_KERNELS if not tf32.get(k)]
    if missing:
        fail(f"no tensor-core instruction in {missing}")
    return counts, tf32


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
    result["f32"] = rel_attention_f32_times(ra, dev, gen)
    return result


def rel_attention_one_tf32(ra, q_u, q_v, k, v, p, mask) -> torch.Tensor:
    """Kernel 1's forward at one TF32 product a multiply (1xTF32): the plain
    version with every product's operands rounded to TF32, P included. With
    TF32 off the products of TF32 values are exact in f32, so only the
    rounding of the operands differs from the f32 plain version."""
    r = tf32_round
    s = (torch.einsum("bhqd,bhkd->bhqk", r(q_u), r(k))
         + ra.rel_shift(torch.einsum("bhqd,hpd->bhqp", r(q_v), r(p)))) / math.sqrt(q_u.shape[-1])
    m = mask[:, None, None, :]
    attn = torch.softmax(s.masked_fill(~m, ra.NEG_INF), dim=-1).masked_fill(~m, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", r(attn), r(v))


def rel_attention_bwd_one_tf32(ra, q_u, q_v, k, v, p, mask, lse, out, g) -> tuple:
    """Kernel 3 at one TF32 product a multiply: rel_attention_bwd_plain's
    formulas with every product's operands rounded to TF32, P, dS and dG
    included."""
    r = tf32_round
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    s = (torch.einsum("bhqd,bhkd->bhqk", r(q_u), r(k))
         + ra.rel_shift(torch.einsum("bhqd,hpd->bhqp", r(q_v), r(p)))) * scale
    valid = mask[:, None, None, :] & (lse > ra.NEG_INF / 2)[..., None]
    prob = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dpr = torch.einsum("bhqd,bhkd->bhqk", r(g), r(v))
    ds = prob * (dpr - (g * out).sum(-1, keepdim=True)) * scale
    dg = ra.rel_unshift(ds)
    return (torch.einsum("bhqk,bhkd->bhqd", r(ds), r(k)),
            torch.einsum("bhqp,hpd->bhqd", r(dg), r(p)),
            torch.einsum("bhqk,bhqd->bhkd", r(ds), r(q_u)),
            torch.einsum("bhqk,bhqd->bhkd", r(prob), r(g)),
            torch.einsum("bhqp,bhqd->hpd", r(dg), r(q_v)))


# f32 shapes of kernels 1 and 3: the server's f32 request (B1 x 96 frames:
# B1 H8 T192, all keys valid, 12 forwards a request), the serving batch's and
# the stage-1 recipe's micro-batch (8 x 600 frames: 24 forwards and 24
# backwards an update through the train_stage1 CLI, which trains in f32)
REL_F32_FWD_SHAPES = ((1, 8, 192), (4, 8, 480), TRAIN_SHAPE)
REL_F32_BWD_SHAPES = ((4, 8, 480), TRAIN_SHAPE)


def rel_attention_f32_times(ra, dev, gen) -> dict:
    """Kernel 1's f32 path (3xTF32) at REL_F32_FWD_SHAPES, ragged (a fully
    masked batch row from batch 4 on): within 1e-4 of its plain version,
    where the forward at one TF32 product (rel_attention_one_tf32) must
    not be; timed with all keys valid beside the plain version, f32 SDPA
    with the position term as a float bias mask, its f32 FMA bound and its
    3xTF32 bound."""
    rows, failures = {}, []
    for b, h, t in REL_F32_FWD_SHAPES:
        (q_u, q_v, k, v, p), mask, _ = bwd_inputs(gen, b, h, t, torch.float32, dev)
        lens = mask.sum(1).tolist()
        out, _ = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
        ref = ra.dense_rel_attention(q_u, q_v, k, v, p, mask)
        err = valid_rows_err(out, ref, lens)
        one = valid_rows_err(rel_attention_one_tf32(ra, q_u, q_v, k, v, p, mask), ref, lens)
        del out, ref
        full = torch.ones(b, t, dtype=torch.bool, device=dev)
        big = t >= TRAIN_SHAPE[2]
        k_ms = time_ms(lambda: ra.rel_attention_kernel(q_u, q_v, k, v, p, full),
                       iters=10 if big else 20)
        plain_ms = time_ms(lambda: ra.dense_rel_attention(q_u, q_v, k, v, p, full),
                           iters=3 if big else 10)
        bias = ra.rel_position_bias(q_v, p)
        lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q_u, k, v, attn_mask=bias), iters=10 if big else 20)
        n_bytes = 5 * b * h * t * 64 * 4 + h * (2 * t - 1) * 64 * 4 + b * t + b * h * t * 4
        flops = 3 * 2 * b * h * t * t * 64
        bms, by = bound_ms(n_bytes, flops, torch.float32)
        row = {"max_abs_err": err, "one_tf32_err": one, "ms": k_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
               "tf32x3_bound_ms": tf32x3_bound_ms(n_bytes, flops)}
        line = (f"rel_attention B{b} H{h} T{t} f32 (3xTF32): max_abs_err {err:.3e} (tol 1e-4; "
                f"1xTF32 {one:.3e}) kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                f"{lib_ms:.4f} (SDPA f32, float bias mask) bound_ms {bms:.4f} ({by}, f32 FMA) "
                f"3xTF32 bound_ms {row['tf32x3_bound_ms']:.4f}")
        print(line, flush=True)
        if not (err <= 1e-4 and one > 1e-4):
            failures.append(line)
        rows[f"B{b}H{h}T{t}"] = row
        del q_u, q_v, k, v, p, bias
        torch.cuda.empty_cache()
    if failures:
        fail(f"rel_attention f32: the kernel exceeds its limit or 1xTF32 passes it: {failures}")
    return rows


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


# f32 limit of the masked attention kernel (3xTF32) on valid rows, absolute:
# ~30x above the CPU emulation of the method (tests/test_torch_attention_tf32.py),
# below one TF32 product (attention_one_tf32), which must fail it
ATTENTION_F32_TOL = 3e-5

# f32 limit of the bias route's forward (3xTF32) on valid rows, absolute: its
# CPU emulation reads 0.7e-6 to 1.9e-6 at T 128-1200, one TF32 product 3.3e-4
# to 8e-4 (tests/test_torch_rel_attention_bias_tf32.py), which must fail it
BIAS_F32_TOL = 1e-4


def attention_one_tf32(att, q, k, v, mask) -> torch.Tensor:
    """Kernel 6's f32 path at one TF32 product a multiply (1xTF32): the plain
    version with both products' operands rounded to TF32, P included."""
    r = tf32_round
    s = torch.einsum("bhqd,bhkd->bhqk", r(q), r(k)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], -1e9)
    return torch.einsum("bhqk,bhkd->bhqd", r(torch.softmax(s, dim=-1)), r(v))


def phase_plain_attention(att, dev) -> dict:
    """The masked attention kernel at the AV-HuBERT trunk's shape (B4 H16 T240 dk64, ragged), at a
    T that is not a tile multiple (also with a fully masked batch row, held
    whole against the plain version's uniform average), at the shape the
    flagship's train step gives it (B8 H16 T600), at the flagship's f32
    request (B1 H16 T96) and at HuBERT's (B1 H12, no mask, up to the 4999
    frames of a full extraction chunk). bf16 times at B4 H16 T240 and B8 H16
    T600; the f32 path (3xTF32) within ATTENTION_F32_TOL of the plain
    version in every f32 case, where attention_one_tf32 must not be (read
    over the same rows), and timed at B1 H16 T96, B4 H16 T240, B1 H12 T500
    and B1 H12 T4999 beside f32 SDPA, the plain version, its f32 FMA bound
    and its 3xTF32 bound."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dk = 64
    result, f32, failures = None, {}, []
    cases = [(4, 16, 240, "ragged", torch.bfloat16, True), (4, 16, 240, "ragged", torch.float32, True),
             (4, 16, 235, "ragged", torch.bfloat16, False), (4, 16, 235, "ragged", torch.float32, False),
             (4, 16, 235, "empty row", torch.bfloat16, False),
             (4, 16, 235, "empty row", torch.float32, False),
             (8, 16, 600, "ragged", torch.bfloat16, True), (8, 16, 600, "ragged", torch.float32, False),
             (1, 16, 96, "ragged", torch.float32, True),        # the flagship's f32 request
             (1, 12, 1499, "no mask", torch.bfloat16, False),
             (1, 12, 1499, "no mask", torch.float32, False),
             (1, 12, 4999, "no mask", torch.float32, True),     # one 1.6 M-sample chunk
             (1, 12, 500, "no mask", torch.float32, True)]      # a 10 s waveform
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
        is_f32 = dtype == torch.float32
        tol = ATTENTION_F32_TOL if is_f32 else 2e-2      # bf16: P and output rounding
        name = str(dtype).replace("torch.", "")
        line = (f"attention B{b} H{h} T{t} {masking} {name}{' (3xTF32)' if is_f32 else ''}: "
                f"max_abs_err {err:.3e} (tol {tol:g}) finite {finite}")
        ok = err <= tol and finite
        if is_f32:
            one = valid_rows_err(attention_one_tf32(att, q, k, v, mask), ref, lens)
            line += f"; 1xTF32 {one:.3e} (must exceed the tol)"
            ok = ok and one > tol
        del out, ref
        if timed:
            k_ms = time_ms(lambda: att.attention_kernel(q, k, v, mask))
            plain_ms = time_ms(lambda: att.reference_attention(q, k, v, mask),
                               iters=5 if t > 2000 else 20)
            lib_mask = None if mask is None else mask[:, None, None, :]
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=lib_mask))
            n_bytes = 4 * b * h * t * dk * q.element_size() + (b * t if mask is not None else 0)
            flops = 4 * b * h * t * t * dk
            bms, by = bound_ms(n_bytes, flops, dtype)
            line += (f" kernel_ms {k_ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f}"
                     f"{' (SDPA f32)' if is_f32 else ''} bound_ms {bms:.4f} ({by}"
                     f"{', f32 FMA' if is_f32 else ''})")
            numbers = {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms}
            if is_f32:
                numbers.update(max_abs_err=err, one_tf32_err=one,
                               tf32x3_bound_ms=tf32x3_bound_ms(n_bytes, flops))
                line += f" 3xTF32 bound_ms {numbers['tf32x3_bound_ms']:.4f}"
                f32[f"B{b}H{h}T{t}"] = numbers
            elif result is None:
                result = {"max_abs_err": err, **numbers}
            else:
                result["train_shape"] = numbers
        if dtype == torch.bfloat16 and result is not None:
            result["max_abs_err"] = max(result["max_abs_err"], err)
        print(line, flush=True)
        if not ok:
            failures.append(line)
        del q, k, v
        torch.cuda.empty_cache()
    if failures:
        fail(f"attention kernel disagrees with its plain version, or 1xTF32 passes the f32 "
             f"limit: {failures}")
    result["f32"] = f32
    return result


def bias_attention_one_tf32(ra, q_u, k, v, bias, mask) -> torch.Tensor:
    """Kernel 4's f32 path at one TF32 product a multiply (1xTF32): the plain
    version with both products' operands rounded to TF32, P included, and
    the f32 bias added unrounded."""
    r = tf32_round
    s = torch.einsum("bhqd,bhkd->bhqk", r(q_u), r(k)) / math.sqrt(q_u.shape[-1]) + bias
    m = mask[:, None, None, :]
    attn = torch.softmax(s.masked_fill(~m, ra.NEG_INF), dim=-1).masked_fill(~m, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", r(attn), r(v))


def bias_attention_bwd_one_tf32(ra, q_u, k, v, bias, mask, lse, out, g) -> tuple:
    """Kernel 5 at one TF32 product a multiply: bias_attention_bwd_plain's
    formulas with every product's operands rounded to TF32, P and dS
    included, and the f32 bias added unrounded: (dq_u, dk, dv, dbias)."""
    r = tf32_round
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", r(q_u), r(k)) * scale + bias
    valid = mask[:, None, None, :] & (lse > ra.NEG_INF / 2)[..., None]
    prob = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dpr = torch.einsum("bhqd,bhkd->bhqk", r(g), r(v))
    dbias = prob * (dpr - (g * out).sum(-1, keepdim=True))
    ds = dbias * scale
    return (torch.einsum("bhqk,bhkd->bhqd", r(ds), r(k)),
            torch.einsum("bhqk,bhqd->bhkd", r(ds), r(q_u)),
            torch.einsum("bhqk,bhqd->bhkd", r(prob), r(g)), dbias)


def bias_fwd_times(ra, gen, dev, b, h, t, mask=None, dtype=torch.bfloat16) -> dict:
    """Kernel 4 beside its plain version, SDPA with the same bias (cast to
    the input type, masked keys at -1e30) and its bound (f32: the f32 FMA
    bound and the 3xTF32 bound, the kernel in 3xTF32); the bias construction
    apart. mask None: all keys valid."""
    dk, sz = 64, torch.finfo(dtype).bits // 8
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
    n_bytes = 4 * b * h * t * dk * sz + 4 * b * h * t * t + b * t + b * h * t * 4
    flops = 2 * 2 * b * h * t * t * dk
    bounds = both_bounds_ms(n_bytes, flops, dtype)
    line = (f"rel_attention_bias B{b} H{h} T{t} {str(dtype)[6:]}: kernel_ms {k_ms:.4f} bias_build_ms "
            f"{build_ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA, the same bias) "
            f"bound_ms {bounds['bound_ms']:.4f} ({bounds['bound_by']}; bytes "
            f"{bounds['bytes_bound_ms']:.4f}, operations {bounds['operations_bound_ms']:.4f})")
    if dtype == torch.float32:
        bounds["tf32x3_bound_ms"] = tf32x3_bound_ms(n_bytes, flops)
        line += f" (f32 FMA) 3xTF32 bound_ms {bounds['tf32x3_bound_ms']:.4f} (3xTF32 kernel)"
    print(line, flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bias_build_ms": build_ms,
            **bounds}


def phase_bias_attention(ra, dev, shear_ms: float) -> dict:
    """The bias-flash kernel at the conformer's shape (B4 H8 T480 dk64, ragged) and at
    T=470 (ragged; a fully masked batch row), f32 and bf16, against its plain
    version, the f32 path (3xTF32) within 1e-4 where the forward at one TF32
    product must not be; bf16 times there and at the train step's B8 H8
    T1200, with the bias construction's beside the shear kernel's; the f32
    path checked the same way at B4 H8 T480 and B8 H8 T1200 (ragged, a fully
    masked batch row) and timed there."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(4)
    b, h, dk = 4, 8, 64
    worst, failures = 0.0, []
    for t, dtype, masking in ((480, torch.bfloat16, "ragged"), (480, torch.float32, "ragged"),
                              (470, torch.bfloat16, "ragged"), (470, torch.float32, "ragged"),
                              (470, torch.bfloat16, "empty row"), (470, torch.float32, "empty row")):
        mk = lambda *s: torch.randn(*s, generator=gen).to(dev, dtype)  # noqa: E731
        q_u, q_v, k, v = (mk(b, h, t, dk) for _ in range(4))
        p = mk(h, 2 * t - 1, dk)
        if masking == "ragged":
            lens, mask = ragged_mask(t, dev)
        else:                                                # batch row 2 has no valid key
            lens = [t, round(0.83 * t), 0, round(0.4 * t)]
            mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        bias = ra.rel_position_bias(q_v, p)                  # f32 whatever the input type
        out, lse = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)
        ref = ra.dense_bias_attention(q_u.float(), k.float(), v.float(), bias, mask)
        s = torch.einsum("bhqd,bhkd->bhqk", q_u.float(), k.float()) / math.sqrt(dk) + bias
        lse_ref = torch.logsumexp(s.masked_fill(~mask[:, None, None, :], ra.NEG_INF), dim=-1)
        torch.cuda.synchronize()
        err = valid_rows_err(out, ref, lens)
        lse_err = valid_rows_err(lse[..., None], lse_ref[..., None], lens)
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        is_f32 = dtype == torch.float32
        tol = BIAS_F32_TOL if is_f32 else 2e-2              # bf16: P and output rounding
        ok = err <= tol and lse_err <= 1e-3 and finite      # the LSE is f32 for both types
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        name = str(dtype).replace("torch.", "")
        line = (f"rel_attention_bias B{b} H{h} T{t} {masking} {name}"
                f"{' (3xTF32)' if is_f32 else ''}: max_abs_err {err:.3e} (tol {tol:g}) "
                f"lse_err {lse_err:.3e} (tol 0.001) finite {finite}")
        if is_f32:
            one = valid_rows_err(bias_attention_one_tf32(ra, q_u, k, v, bias, mask), ref, lens)
            line += f"; 1xTF32 {one:.3e} (must exceed the tol)"
            ok = ok and one > tol
        print(line, flush=True)
        if not ok:
            failures.append(line)
    if failures:
        fail("rel_attention_bias kernel disagrees with its plain version, or 1xTF32 passes the "
             "f32 limit")
    result = {"max_abs_err": worst, **bias_fwd_times(ra, gen, dev, b, h, 480, ragged_mask(480, dev)[1]),
              "train_shape": bias_fwd_times(ra, gen, dev, *TRAIN_SHAPE)}
    # the f32 path (3xTF32) at the serving batch's and the train step's shapes:
    # checked on ragged inputs with a fully masked batch row, timed with all keys valid
    result["f32"] = {}
    for b, h, t in REL_F32_BWD_SHAPES:
        (q_u, q_v, k, v, p), mask, _ = bwd_inputs(gen, b, h, t, torch.float32, dev)
        lens, bias = mask.sum(1).tolist(), ra.rel_position_bias(q_v, p)
        ref = ra.dense_bias_attention(q_u, k, v, bias, mask)
        err = valid_rows_err(ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)[0], ref, lens)
        one = valid_rows_err(bias_attention_one_tf32(ra, q_u, k, v, bias, mask), ref, lens)
        print(f"rel_attention_bias B{b} H{h} T{t} ragged float32 (3xTF32): max_abs_err {err:.3e} "
              f"(tol {BIAS_F32_TOL:g}); 1xTF32 {one:.3e} (must exceed the tol)", flush=True)
        if not (err <= BIAS_F32_TOL < one):
            fail(f"rel_attention_bias B{b} H{h} T{t} f32: the kernel exceeds its limit or 1xTF32 "
                 "passes it")
        del q_u, q_v, k, v, p, bias, ref
        torch.cuda.empty_cache()
        result["f32"][f"B{b}H{h}T{t}"] = {"max_abs_err": err, "one_tf32_err": one,
                                          **bias_fwd_times(ra, gen, dev, b, h, t, dtype=torch.float32)}
        torch.cuda.empty_cache()
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


def trio_bytes(x, ws) -> int:
    """x read and the output written once, every weight and bias read once."""
    return 2 * x.numel() * x.element_size() + sum(
        w.numel() * w.element_size() + bb.numel() * bb.element_size()
        for rb in ws for pair in rb for w, bb in pair)


# The trio's f32 path against trio_plain (TF32 off), of max(1, |ref|): 3xTF32
# reads at most 2.1e-6 on an H100, a copy of the kernel at one TF32 product a
# multiply (1xTF32) 5.2e-5 to 6.4e-5, which must fail it, as trio_one_tf32
# must at every timed shape.
TRIO_F32_TOL = 2e-5


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 as cvt.rna.tf32.f32 rounds: half a TF32 ulp added
    to the f32 bits, the 13 low bits dropped."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def trio_one_tf32(ft, x, ws, ks, dils) -> torch.Tensor:
    """The trio at one TF32 product a multiply (1xTF32): trio_plain with
    every conv's input (after its lrelu) and weights rounded to TF32. With
    TF32 off the products of TF32 values are exact in f32, so only the
    rounding of the operands differs from the f32 trio."""
    def conv(v, w, b, pad, d):
        return ft.ops.conv1d(tf32_round(ft.ops.leaky_relu(v, ft.LRELU_SLOPE)), tf32_round(w), b,
                             padding=pad, dilation=d)
    acc = None
    for rb, k, ds in zip(ws, ks, dils):
        y = x
        for ((w1, b1), (w2, b2)), d in zip(rb, ds):
            p1, p2 = ft.ops.branch_paddings(k, d)
            y = y + conv(conv(y, w1, b1, p1, d), w2, b2, p2, 1)
        acc = y if acc is None else acc + y
    return acc / len(ws)


def phase_trio(ft, dev, vcfg) -> dict:
    """Kernel 2 per stage width, both dtypes, at the batch-4 x 240-frame and
    batch-1 x 96-frame row counts (each timed beside its plain version, its
    bound, and in f32 the 3xTF32 bound beside the FMA one; the tile and
    blocks a stage) plus a row count that is not a tile multiple. Returns
    the bf16 totals at batch 4 (the kernels line's numbers) with each
    stage's numbers and the f32 totals at both shapes. f32 is held to
    TRIO_F32_TOL, which the trio at one TF32 product must fail at both
    timed shapes."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(2)
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = [tuple(d) for d in vcfg.resblock_dilation_sizes]
    macs_per_row = sum(2 * k * len(d) for k, d in zip(ks, dils))  # x C^2
    b, frames = 4, 240
    rows = frames * 4                          # mel rows per item
    sums = {(dtype, shape): {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
            for dtype in (torch.bfloat16, torch.float32) for shape in ("B4x240", "B1x96")}
    stages = []
    bound_kind = set()
    failures = []
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}   # over every shape
    c = vcfg.upsample_initial_channel
    for u in vcfg.upsample_rates:
        c //= 2
        rows *= u
        if c > 128:
            continue
        stage = {"channels": c}
        for dtype in (torch.bfloat16, torch.float32):
            ws = trio_weights(gen, c, ks, dils, dtype, dev)
            name = str(dtype).replace("torch.", "")
            for bsz, m, timed in ((b, rows, "B4x240"), (2, 1000 + 37, None),
                                  (1, rows * 96 // 240, "B1x96")):
                x = (torch.randn(bsz, c, m, generator=gen) * 0.5).to(dev, dtype)
                out = ft.fused_resblock_trio_kernel(x, ws, ks, dils)
                ref = ft.trio_plain(x, ws, ks, dils)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                scale = max(1.0, float(ref.float().abs().max()))
                # f32: summation order (3xTF32 drops ~2^-22 of each product);
                # bf16: both round after every op, so a one-ulp split early in
                # the 18-conv chain can propagate
                tol = (TRIO_F32_TOL if dtype == torch.float32 else 3e-2) * scale
                finite = bool(torch.isfinite(out.float()).all())
                max_err[dtype] = max(max_err[dtype], err)
                line = (f"fused_trio C{c} B{bsz} M{m} {name}: max_abs_err {err:.3e} "
                        f"(tol {tol:.3g}) finite {finite}")
                if timed and dtype == torch.float32:
                    one = float((trio_one_tf32(ft, x, ws, ks, dils) - ref).abs().max())
                    line += f" 1xTF32 {one:.3e}"
                    if not one > tol:
                        failures.append(f"{line}: 1xTF32 passes the f32 limit")
                if timed:
                    k_ms = time_ms(lambda: ft.fused_resblock_trio_kernel(x, ws, ks, dils), iters=5)
                    p_ms = time_ms(lambda: ft.trio_plain(x, ws, ks, dils), iters=5)
                    n_bytes, flops = trio_bytes(x, ws), 2 * macs_per_row * c * c * bsz * m
                    bms, by = bound_ms(n_bytes, flops, dtype)
                    tile = ft.tile_rows(c, dtype, ft._geometry(ks, dils)[1], m, bsz,
                                        ft._sm_count(x.device), ks, tuple(dils))
                    numbers = {"rows": m, "batch": bsz, "ms": k_ms, "plain_ms": p_ms,
                               "bound_ms": bms, "tile": tile, "blocks": bsz * -(-m // tile)}
                    line += (f" kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {bms:.4f} ({by})")
                    if dtype == torch.float32:
                        numbers["tf32x3_bound_ms"] = tf32x3_bound_ms(n_bytes, flops)
                        line += f" 3xTF32 bound_ms {numbers['tf32x3_bound_ms']:.4f}"
                    line += f" tile {tile} blocks {numbers['blocks']}"
                    stage[timed if dtype == torch.bfloat16 else f"f32_{timed}"] = numbers
                    acc = sums[(dtype, timed)]
                    for key in ("ms", "plain_ms", "bound_ms", "tf32x3_bound_ms"):
                        if key in numbers:
                            acc[key] = acc.get(key, 0.0) + numbers[key]
                    if dtype == torch.bfloat16 and timed == "B4x240":
                        bound_kind.add(by)
                print(line, flush=True)
                if not (err <= tol and finite):
                    failures.append(line)
        stages.append(stage)
    if failures:
        fail(f"fused trio kernel disagrees with its plain version: {failures}")
    slower = [f"C{st['channels']} {shape}" for st in stages
              for shape in ("B4x240", "B1x96", "f32_B4x240", "f32_B1x96")
              if st[shape]["ms"] > st[shape]["plain_ms"]]
    for (dtype, shape), acc in sums.items():
        extra = (f" 3xTF32 bound_ms {acc['tf32x3_bound_ms']:.4f}"
                 if dtype == torch.float32 else "")
        print(f"fused_trio {str(dtype)[6:]} {shape} four stages: kernel_ms {acc['ms']:.4f} "
              f"plain_ms {acc['plain_ms']:.4f} bound_ms {acc['bound_ms']:.4f}{extra}", flush=True)
    print(f"fused_trio stages slower than their plain version: {slower or 'none'}", flush=True)
    totals = dict(sums[(torch.bfloat16, "B4x240")])
    totals["max_abs_err"] = max_err[torch.bfloat16]
    totals["bound_by"] = "/".join(sorted(bound_kind))
    totals["library_ms"] = None                 # no single PyTorch call does a trio
    totals["stages"] = stages
    totals["f32"] = {shape: sums[(torch.float32, shape)] for shape in ("B4x240", "B1x96")}
    totals["f32"]["max_abs_err"] = max_err[torch.float32]
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


def profile_call(fn, what: str, top: int = 12, by_name: dict | None = None) -> float:
    """Device time by kernel over one call of fn, and the device's busy share
    of the call's wall time (torch.profiler, CUPTI). Returns the device's
    busy milliseconds; by_name, when given, gets each kernel's ms by name."""
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
    # repeat the time of the kernels they launched, and a user annotation's
    # device range (Optimizer.step#AdamW.step) that of the kernels inside it
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)
                   and e.key != "Activity Buffer Request"), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    if by_name is not None:
        by_name.update({e.key: dev_us(e) / 1e3 for e in rows})
    notes = [f"{e.key} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in prof.key_averages()
             if getattr(e, "is_user_annotation", False) and dev_us(e) > 0]
    print(f"profile {what}: wall_ms {wall_ms:.3f} (profiled) device_busy_ms {busy_ms:.3f} "
          f"busy_share {busy_ms / wall_ms:.3f} kernels {sum(e.count for e in rows)}"
          + (f"; annotation ranges left out: {notes}" if notes else ""), flush=True)
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


def phase_f32_request(syn, counters: dict, name: str, cfg, expected: dict) -> dict:
    """The full-width preset `name` in f32 (the server's default dtype, TF32
    off), PCM16 out, at both request shapes: exact launch counts per
    forward, results checked, p50 of 10 calls, one profiled request each
    with the masked attention kernel's share of the device's busy time."""
    set_tf32(False)
    pipe = syn.Lip2SpeechPipeline.initialize_random(cfg, seed=0, emit_int16=True)
    pipe.warmup(buckets=(240,), batch_sizes=(4,))
    pipe.warmup(buckets=(96,), batch_sizes=(1,))
    read = {}
    for b, frames, lens in ((1, 96, (96,)), (4, 240, MAIN_LENS)):
        what = f"{name} B{b}x{frames} f32"
        req = request(cfg, b, frames, lens, seed=b)
        check_results(counted_request(counters, pipe, req, expected, what), lens, what)
        p50, lo, hi = p50_ms(pipe, req)
        by_name: dict = {}
        busy = profile_call(lambda: pipe.synthesise_batch(*req), what, top=8, by_name=by_name)
        att_ms = sum(ms for k, ms in by_name.items() if "attention_mma" in k and "rel_" not in k)
        read[f"B{b}x{frames}"] = {"p50_ms": p50, "min_ms": lo, "max_ms": hi, "busy_ms": busy,
                                  "attention_ms": att_ms, "attention_share": att_ms / busy}
        print(f"{what} pcm16: p50_ms {p50:.3f} min_ms {lo:.3f} max_ms {hi:.3f} (10 calls); "
              f"device_busy_ms {busy:.3f}, attention kernel {att_ms:.3f} ms "
              f"({100 * att_ms / busy:.1f}%)", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return read


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


def shear_bwd_times(ra, gen, dev, b, h, t, dtype=torch.bfloat16) -> dict:
    """Kernel 3 (all keys valid) beside its bound, its plain version and the
    backward of SDPA with the position term as a float bias mask; in f32
    (3xTF32) the f32 FMA bound and the 3xTF32 bound."""
    dk, sz = 64, torch.finfo(dtype).bits // 8
    (q_u, q_v, k, v, p), _, g = bwd_inputs(gen, b, h, t, dtype, dev)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
    k_ms = time_ms(lambda: ra.rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g),
                   iters=5 if dtype == torch.float32 and t >= TRAIN_SHAPE[2] else 10)
    plain_ms = time_ms(lambda: ra.rel_attention_bwd_plain(q_u, q_v, k, v, p, mask, lse, out, g), iters=3)
    lib_ms = sdpa_bwd_ms(q_u, k, v, ra.rel_position_bias(q_v, p).to(dtype), g)
    # inputs q_u q_v k v out dO and p, mask, lse once; outputs dq_u dq_v dk dv and dp once
    n_bytes = 10 * b * h * t * dk * sz + 2 * h * (2 * t - 1) * dk * sz + b * t + b * h * t * 4
    flops = 8 * 2 * b * h * t * t * dk
    bms, by = bound_ms(n_bytes, flops, dtype)
    res = {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}
    line = (f"rel_attention_bwd B{b} H{h} T{t} {str(dtype)[6:]}: kernel_ms {k_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA backward, float bias mask) bound_ms "
            f"{bms:.4f} ({by})")
    if dtype == torch.float32:
        res["tf32x3_bound_ms"] = tf32x3_bound_ms(n_bytes, flops)
        line += f" (f32 FMA) 3xTF32 bound_ms {res['tf32x3_bound_ms']:.4f}"
    print(line, flush=True)
    return res


def shear_bwd_one_tf32_errs(ra, gen, dev, b, h, t) -> tuple[float, float]:
    """Kernel 3's f32 path and the backward at one TF32 product
    (rel_attention_bwd_one_tf32) against the plain version on ragged inputs
    with a fully masked batch row: the largest error over the five
    gradients, each over max(1, |ref|)."""
    (q_u, q_v, k, v, p), mask, g = bwd_inputs(gen, b, h, t, torch.float32, dev)
    out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
    plain = ra.rel_attention_bwd_plain(q_u, q_v, k, v, p, mask, lse, out, g)
    got = ra.rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g)
    one = rel_attention_bwd_one_tf32(ra, q_u, q_v, k, v, p, mask, lse, out, g)
    return max(grad_errs(got, plain)), max(grad_errs(one, plain))


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

    # f32 (3xTF32) at its timed shapes: within the limit, where 1xTF32 is not
    f32 = {}
    for b, h, t in REL_F32_BWD_SHAPES:
        err, one = shear_bwd_one_tf32_errs(ra, gen, dev, b, h, t)
        tol = bwd_tolerance(torch.float32)
        print(f"rel_attention_bwd B{b} H{h} T{t} float32 (3xTF32): max err / max(1,|ref|) "
              f"{err:.2e} (tol {tol:g}); 1xTF32 {one:.2e}", flush=True)
        if not (err <= tol and one > tol):
            fail(f"rel_attention_bwd B{b} H{h} T{t} f32: the kernel exceeds its limit or 1xTF32 "
                 "passes it")
        torch.cuda.empty_cache()
        f32[f"B{b}H{h}T{t}"] = {"max_abs_err": err, "one_tf32_err": one,
                                **shear_bwd_times(ra, gen, dev, b, h, t, torch.float32)}
        torch.cuda.empty_cache()
    # times at the serving shape and at the training shape, bf16, all keys valid
    serving = shear_bwd_times(ra, gen, dev, 4, 8, 480)
    shear = {"max_abs_err": worst["shear"], **shear_bwd_times(ra, gen, dev, *TRAIN_SHAPE),
             "serving_shape": serving, "f32": f32}
    bias_serving = bias_bwd_times(ra, gen, dev, 4, 8, 480, serving["ms"])
    bias_res = {"max_abs_err": worst["bias"], **bias_bwd_times(ra, gen, dev, *TRAIN_SHAPE, shear["ms"]),
                "serving_shape": bias_serving, "f32": {}}
    for b, h, t in REL_F32_BWD_SHAPES:     # the bias route's f32 path (3xTF32)
        shape, tol = f"B{b}H{h}T{t}", bwd_tolerance(torch.float32)
        errs = bias_bwd_one_tf32_errs(ra, gen, dev, b, h, t)
        print(f"rel_attention_bias_bwd B{b} H{h} T{t} float32 (3xTF32): max err / max(1,|ref|) "
              f"{errs['max_abs_err']:.2e} (tol {tol:g}), dbias {fmt_errs(errs['dbias_err'])}; "
              f"1xTF32 {errs['one_tf32_err']:.2e}, dbias {fmt_errs(errs['one_tf32_dbias_err'])} "
              f"(must fail a limit)", flush=True)
        if not (errs["max_abs_err"] <= tol and dbias_ok(errs["dbias_err"])) or (
                errs["one_tf32_err"] <= tol and dbias_ok(errs["one_tf32_dbias_err"])):
            fail(f"rel_attention_bias_bwd B{b} H{h} T{t} f32: the kernel exceeds its limits or "
                 "1xTF32 passes them")
        torch.cuda.empty_cache()
        bias_res["f32"][shape] = {**errs, **bias_bwd_times(ra, gen, dev, b, h, t, f32[shape]["ms"],
                                                           dtype=torch.float32)}
        torch.cuda.empty_cache()
    return shear, bias_res


def bias_bwd_one_tf32_errs(ra, gen, dev, b, h, t) -> dict:
    """Kernel 5's f32 path and the backward at one TF32 product
    (bias_attention_bwd_one_tf32) against the plain version on ragged inputs
    with a fully masked batch row: the largest error over dq_u, dk and dv,
    each over max(1, |ref|), and dbias's errors (dbias_errs)."""
    (q_u, q_v, k, v, p), mask, g = bwd_inputs(gen, b, h, t, torch.float32, dev)
    bias = ra.rel_position_bias(q_v, p)
    out, lse = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)
    plain = ra.bias_attention_bwd_plain(q_u, k, v, bias, mask, lse, out, g)
    got = ra.rel_attention_bias_bwd_kernel(q_u, k, v, bias, mask, lse, out, g)
    errs = {"max_abs_err": max(grad_errs(got[:3], plain[:3])),
            "dbias_err": dbias_errs(got[3], plain[3])}
    del got
    one = bias_attention_bwd_one_tf32(ra, q_u, k, v, bias, mask, lse, out, g)
    errs.update(one_tf32_err=max(grad_errs(one[:3], plain[:3])),
                one_tf32_dbias_err=dbias_errs(one[3], plain[3]))
    return errs


def bias_bwd_times(ra, gen, dev, b, h, t, shear_ms: float, dtype=torch.bfloat16) -> dict:
    """Kernel 5 (all keys valid) beside its bound (f32: the f32 FMA bound and
    the 3xTF32 bound, the kernel in 3xTF32), its plain version, the backward of SDPA with the same
    bias as a float mask, and the autograd of the bias construction that
    follows it in the route."""
    dk, sz = 64, torch.finfo(dtype).bits // 8
    (q_u, q_v, k, v, p), _, g = bwd_inputs(gen, b, h, t, dtype, dev)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    bias = ra.rel_position_bias(q_v, p)
    out, lse = ra.rel_attention_bias_kernel(q_u, k, v, bias, mask)
    iters = 20 if t < 1000 and dtype == torch.bfloat16 else 5
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
    flops = 5 * 2 * b * h * t * t * dk
    bounds = both_bounds_ms(n_bytes, flops, dtype)
    tf32x3 = ""
    if dtype == torch.float32:
        bounds["tf32x3_bound_ms"] = tf32x3_bound_ms(n_bytes, flops)
        tf32x3 = f" (f32 FMA) 3xTF32 bound_ms {bounds['tf32x3_bound_ms']:.4f}"
    print(f"rel_attention_bias_bwd B{b} H{h} T{t} {str(dtype)[6:]}: kernel_ms {k_ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA backward, the same bias) bound_ms "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']}; bytes {bounds['bytes_bound_ms']:.4f}, "
          f"operations {bounds['operations_bound_ms']:.4f}){tf32x3}; autograd of rel_position_bias "
          f"{bias_bwd_ms:.4f} ms: bias route backward {k_ms + bias_bwd_ms:.4f} ms | shear route "
          f"backward {shear_ms:.4f} ms", flush=True)
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


def phase_train_f32(s1, counters: dict, preset, bias_construction_ms: float) -> dict:
    """The f32 stage-1 step as the train_stage1 CLI runs it (bf16_compute
    False; PyTorch's TF32 defaults, which the CLI keeps: matmuls in f32,
    cuDNN's convs in TF32): multi_target at full width, dropout 0.1, 8 x
    600 frames, accumulation 2; for each rel-position attention route, the
    shear route (default) and then the bias route, three optimizer steps
    with exact launch counts (24 forwards and 24 backwards, their f32 paths
    in 3xTF32), p50, peak memory, one profiled step with the route's kernels'
    share of its device busy time. bias_construction_ms: the bias route's
    24 constructions of the f32 bias and their autograd at B8 H8 T1200, read
    apart in phases 7 and 11, printed beside its kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    base, accum = preset("multi_target"), 2
    cfg = dataclasses.replace(base, stage1=dataclasses.replace(
        base.stage1, warmup_updates=2, max_updates=10, update_freq=accum, bf16_compute=False))
    frames, layers = cfg.stage1.max_sample_size, cfg.model.conformer.layers
    state = s1.create_train_state(cfg, seed=0)
    step = s1.make_train_step(cfg)
    batch = train_batch(cfg, accum, cfg.stage1.batch_size, frames, seed=0)
    reads = {}
    for impl, lib in (("shear", "rel_attention"), ("bias", "rel_attention_bias")):
        expected = {lib: layers * accum, f"{lib}_bwd": layers * accum}
        what = f"train multi_target f32 8x{frames} impl={impl}"
        with flash_impl(impl):
            torch.cuda.reset_peak_memory_stats()
            times, logs = [], []
            for i in range(3):
                lg, ms, counts = counted_step(counters, step, state, batch, expected,
                                              f"{what} step {i + 1}")
                times.append(ms)
                logs.append(lg["loss"] / lg["sample_size"])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if impl == "shear" and not logs[2] < logs[0]:
                fail(f"{what}: the loss did not fall")
            by_name: dict = {}
            busy = profile_call(lambda: step(state, batch), what, top=12, by_name=by_name)
        rel_ms = sum(ms for name, ms in by_name.items() if "rel_" in name or "row_dot" in name)
        read = {"step_ms": times, "p50_ms": float(np.median(times)), "peak_gib": peak,
                "busy_ms": busy, "rel_attention_ms": rel_ms, "rel_attention_share": rel_ms / busy,
                "launches": {k: counts[k] for k in expected}}
        line = (f"{what}: step_ms {[round(t, 1) for t in times]} p50 {read['p50_ms']:.1f}; peak "
                f"memory {peak:.2f} GiB; device busy {busy:.1f} ms, of it {lib}{{,_bwd}} "
                f"{rel_ms:.1f} ms ({rel_ms / busy:.3f})")
        if impl == "bias":
            read["bias_construction_ms"] = bias_construction_ms
            line += (f"; beside them the bias construction and its autograd, 24 x at B8 H8 T1200 "
                     f"read apart: {bias_construction_ms:.1f} ms")
        print(line, flush=True)
        reads[impl] = read
    del state, step
    torch.cuda.empty_cache()
    return reads


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

def gan_stage_rows(vcfg) -> list[tuple[int, int]]:
    """(channels, rows) of each <=128-channel generator stage at one
    stage-2 training segment: the conditioning's segment / mel_hop rows times
    the upsample rates so far."""
    rows, c, out = vcfg.segment_size // vcfg.mel_hop_size, vcfg.upsample_initial_channel, []
    for u in vcfg.upsample_rates:
        c //= 2
        rows *= u
        if c <= 128:
            out.append((c, rows))
    return out


def phase_trio_gan(ft, dev, vcfg, batch: int) -> dict:
    """Kernel 2's f32 path at the GAN step's shapes (batch x one segment per
    stage), TF32 off: against its plain version (TRIO_F32_TOL of max(1,
    |ref|), which the trio at one TF32 product must fail), timed beside the
    plain version (cuDNN's 18 f32 convs), the f32 FMA operations bound and
    the 3xTF32 bound."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(5)
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = [tuple(d) for d in vcfg.resblock_dilation_sizes]
    macs_per_row = sum(2 * k * len(d) for k, d in zip(ks, dils))
    stages, failures = [], []
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "tf32x3_bound_ms": 0.0,
              "max_abs_err": 0.0}
    for c, m in gan_stage_rows(vcfg):
        ws = trio_weights(gen, c, ks, dils, torch.float32, dev)
        x = (torch.randn(batch, c, m, generator=gen) * 0.5).to(dev)
        with torch.no_grad():
            out = ft.fused_resblock_trio_kernel(x, ws, ks, dils)
            ref = ft.trio_plain(x, ws, ks, dils)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = TRIO_F32_TOL * max(1.0, float(ref.abs().max()))
            one = float((trio_one_tf32(ft, x, ws, ks, dils) - ref).abs().max())
            k_ms = time_ms(lambda: ft.fused_resblock_trio_kernel(x, ws, ks, dils), iters=5)
            p_ms = time_ms(lambda: ft.trio_plain(x, ws, ks, dils), iters=5)
        n_bytes, flops = trio_bytes(x, ws), 2 * macs_per_row * c * c * batch * m
        bms, by = bound_ms(n_bytes, flops, torch.float32)
        tf32_bms = tf32x3_bound_ms(n_bytes, flops)
        line = (f"fused_trio GAN shape C{c} B{batch} M{m} f32: max_abs_err {err:.3e} (tol {tol:.3g}) "
                f"1xTF32 {one:.3e} kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {bms:.4f} "
                f"({by}, {flops / 1e9:.1f} GFLOP) 3xTF32 bound_ms {tf32_bms:.4f}")
        print(line, flush=True)
        if not (err <= tol and bool(torch.isfinite(out).all())):
            failures.append(line)
        if not one > tol:
            failures.append(f"{line}: 1xTF32 passes the f32 limit")
        stages.append({"channels": c, "rows": m, "batch": batch, "ms": k_ms, "plain_ms": p_ms,
                       "bound_ms": bms, "bound_by": by, "tf32x3_bound_ms": tf32_bms,
                       "max_abs_err": err})
        totals["ms"] += k_ms
        totals["plain_ms"] += p_ms
        totals["bound_ms"] += bms
        totals["tf32x3_bound_ms"] += tf32_bms
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
    if failures:
        fail(f"fused trio f32 disagrees with its plain version at the GAN shapes: {failures}")
    print(f"fused_trio f32 GAN shapes, four stages: kernel_ms {totals['ms']:.4f} plain_ms "
          f"{totals['plain_ms']:.4f} bound_ms {totals['bound_ms']:.4f} 3xTF32 bound_ms "
          f"{totals['tf32x3_bound_ms']:.4f}", flush=True)
    return {**totals, "stages": stages}


def phase_trio_fn(ft, voc, dev, vcfg, c: int = 64, batch: int = 16) -> None:
    """TrioFn on the card at one GAN stage (C64, B16, one segment's rows),
    f32, TF32 off: fused_resblock_trio under grad goes through TrioFn and
    launches the kernel once; the output, dx and the gradients of every
    weight_v, weight_g and bias against autograd through trio_plain, each
    within 1e-4 of its tensor's largest reference element (the backward is
    that recompute; only cuDNN's order of sums differs)."""
    set_tf32(False)
    ks = tuple(vcfg.resblock_kernel_sizes)
    dils = [tuple(d) for d in vcfg.resblock_dilation_sizes]
    m = dict(gan_stage_rows(vcfg))[c]
    gen = torch.Generator().manual_seed(6)
    rbs = [voc.ResBlock1(c, k, d) for k, d in zip(ks, dils)]
    for rb in rbs:
        for conv in rb.modules():
            if isinstance(conv, voc.WNConv1d):
                conv.init_random(gen)
                with torch.no_grad():             # gains away from ||v||, weights ~ 0.2/sqrt(C K)
                    conv.weight_g.mul_(20 * (torch.rand(conv.weight_g.shape, generator=gen) + 0.5))
        rb.to(dev)
    params = [p for rb in rbs for p in rb.parameters()]
    x0 = (torch.randn(batch, c, m, generator=gen) * 0.5).to(dev)
    g = torch.randn(batch, c, m, generator=gen).to(dev)
    results = {}
    for route in ("kernel", "plain"):
        x = x0.clone().requires_grad_()
        ws = [rb.branch_weights() for rb in rbs]
        ft.fused_resblock_trio_kernel.launches = 0
        if route == "kernel":
            out = ft.fused_resblock_trio(x, ws, ks, dils)
            launched = ft.fused_resblock_trio_kernel.launches
            via = type(out.grad_fn).__name__
        else:
            out = ft.trio_plain(x, ws, ks, dils)
        results[route] = (out.detach(), *torch.autograd.grad(out, [x, *params], g))
    torch.cuda.synchronize()
    names = ["out", "dx"] + [n for i in range(len(rbs)) for n, _ in rbs[i].named_parameters(
        prefix=f"resblocks_{i}")]
    errs = {n: float((a - b).abs().max()) / float(b.abs().max())
            for n, a, b in zip(names, results["kernel"], results["plain"])}
    worst = max(errs, key=errs.get)
    print(f"TrioFn C{c} B{batch} M{m} f32: grad_fn {via}, launches {launched}; {len(errs)} "
          f"tensors, worst max err / its largest reference element {errs[worst]:.3e} at {worst} "
          f"(tol 1e-4); out {errs['out']:.3e} dx {errs['dx']:.3e}", flush=True)
    if via != "TrioFnBackward" or launched != 1:
        fail("fused_resblock_trio under grad did not go through TrioFn and the kernel")
    if not errs[worst] <= 1e-4:
        fail("TrioFn's gradients disagree with autograd through the plain trio")


def gan_batch(cfg, b: int, seed: int) -> dict:
    """A synthetic stage-2 batch of b segments: tones plus noise, random
    units, mels and speaker embeddings."""
    rng = np.random.default_rng(seed)
    n = cfg.vocoder.segment_size
    t = np.arange(n) / cfg.audio.sample_rate
    audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400, (b, 1)) * t) + 0.05 * rng.standard_normal((b, n))
    return {"audio": audio.astype(np.float32),
            "code": rng.integers(0, cfg.vocoder.num_embeddings, (b, n // cfg.vocoder.code_hop_size)),
            "mel": rng.standard_normal((b, n // cfg.vocoder.mel_hop_size, 80)).astype(np.float32),
            "spk_emb": rng.standard_normal((b, cfg.vocoder.embedder_dim)).astype(np.float32)}


def counted_gan_step(counters: dict, step, state, batch, expected: dict, what: str):
    """One GAN step with every launch count set to 0 just before and read
    just after; returns (logs as floats, wall ms)."""
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
    print(f"{what}: step_ms {ms:.1f} launches {counts} logs "
          f"{ {k: round(v, 5) for k, v in logs.items()} }", flush=True)
    if counts != want:
        fail(f"{what}: expected launches {want}, got {counts}")
    if not all(math.isfinite(v) for v in logs.values()):
        fail(f"{what}: non-finite logs {logs}")
    return logs, ms


@contextlib.contextmanager
def trio_stages_plain(voc, ft):
    """For a comparison only (the plain version of the GAN step, as plain_ms
    is a kernel's): the generator's trio stages on trio_plain, cuDNN's 18
    convs under autograd, instead of the kernel. The port has no such route:
    on the card its trio stages always launch the kernel."""
    real = voc.fused_resblock_trio
    voc.fused_resblock_trio = ft.trio_plain
    try:
        yield
    finally:
        voc.fused_resblock_trio = real


def phase_gan_step(s2, voc, ft, counters: dict, preset) -> dict:
    """Stage-2 GAN training at full width: multi_target's vocoder, the
    recipe's batch of 16 x 8,960-sample segments, f32, dropout 0.1, TF32 as
    torch leaves it (cuDNN convs may use it, matmuls not). Three steps with
    exactly 4 trio launches each, p50 and peak memory; one profiled step;
    then, for comparison, three steps and one profiled step with the trio
    stages on the plain trio (0 launches): the step's plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False       # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    cfg = preset("multi_target")
    b = cfg.stage2.batch_size
    n_trio = n_trio_stages(cfg.vocoder)
    what = f"GAN step multi_target {b}x{cfg.vocoder.segment_size} f32"
    t0 = time.perf_counter()
    state = s2.create_gan_state(cfg, seed=0)
    step = s2.make_gan_step(cfg)
    n_params = {k: sum(p.numel() for p in getattr(state, k).parameters())
                for k in ("generator", "mpd", "msd")}
    print(f"{what}: init s {time.perf_counter() - t0:.1f} parameters "
          f"{ {k: round(v / 1e6, 2) for k, v in n_params.items()} } M (TF32: cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32})",
          flush=True)
    batch = gan_batch(cfg, b, seed=0)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        _, ms = counted_gan_step(counters, step, state, batch, {"fused_resblock_trio": n_trio},
                                 f"{what} step {i + 1}")
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{what}: step_ms {[round(t, 1) for t in times]} p50 {float(np.median(times)):.1f}; "
          f"peak memory {peak:.2f} GiB; step {state.step}", flush=True)
    if state.step != 3:
        fail(f"{what}: the state took {state.step} steps, not 3")
    for c in counters.values():
        c.launches = 0
    busy = profile_call(lambda: step(state, batch), what, top=16)
    profiled_trio = counters["fused_resblock_trio"].launches
    val = float(s2.validation_mel_l1(state.generator, batch, cfg))
    print(f"{what}: trio launches in the profiled step {profiled_trio}; validation_mel_l1 "
          f"{val:.4f}", flush=True)
    if profiled_trio != n_trio or not math.isfinite(val):
        fail(f"{what}: profiled step launched the trio {profiled_trio} times or validation failed")
    plain_what = f"{what}, trio stages on trio_plain (comparison)"
    with trio_stages_plain(voc, ft):
        plain_times = [counted_gan_step(counters, step, state, batch, {},
                                        f"{plain_what} step {i + 1}")[1] for i in range(3)]
        plain_busy = profile_call(lambda: step(state, batch), plain_what, top=8)
    print(f"{plain_what}: step_ms {[round(t, 1) for t in plain_times]} p50 "
          f"{float(np.median(plain_times)):.1f}; device busy {plain_busy:.3f} ms against "
          f"{busy:.3f} with the kernel", flush=True)
    del state, step
    torch.cuda.empty_cache()
    return {"gan_step_launches": n_trio, "gan_step_p50_ms": float(np.median(times)),
            "gan_step_busy_ms": busy, "gan_step_peak_gib": peak,
            "gan_step_p50_ms_trio_plain": float(np.median(plain_times)),
            "gan_step_busy_ms_trio_plain": plain_busy}


GAN_CHECK_TOL = {"logs": 1e-4,        # relative
                 "disc": 1e-5,        # D gradients / the discriminators' largest element
                 "generator": 2e-4,   # G gradients / the generator's largest element
                 "par": 2e-5,         # parameters after two steps, absolute
                 "u": 1e-5}           # spectral u, absolute
GRAD_AGREE = 1e-3                     # per tensor, 2-norm: the parameter check's filter
TRIO_PATH_AGREE = 5e-3                # per tensor on the trio's path, 2-norm: sound 1.7e-3
                                      # (a weight_g, a reduction of dL/dw against v), the
                                      # faulty backwards 1e-2 and more


def trio_path(vcfg) -> tuple[str, ...]:
    """Name prefixes of the generator parameters whose gradients TrioFn
    gives or passes on: each trio stage's upsampler and resblocks."""
    n_k = len(vcfg.resblock_kernel_sizes)
    out, c = [], vcfg.upsample_initial_channel
    for i in range(len(vcfg.upsample_rates)):
        c //= 2
        if c <= 128:
            out += [f"generator.generator.ups_{i}."] + [
                f"generator.generator.resblocks_{i * n_k + j}." for j in range(n_k)]
    return tuple(out)


@contextlib.contextmanager
def faulty_trio_backward(ft, fault: str):
    """A deliberately wrong TrioFn backward, to show that the card-against-
    CPU check fails on it: 'bias gradients dropped' (every trio bias gets
    0), 'dx 1% off' (the gradient passed upstream x 1.01), 'one weight
    gradient 1% off' (the first conv of each stage's first resblock)."""
    real = ft.TrioFn.backward

    def backward(ctx, grad_out):
        g = list(real(ctx, grad_out))          # dx, 3 x None, then (w, b) per conv
        if fault == "bias gradients dropped":
            g[5::2] = [torch.zeros_like(t) for t in g[5::2]]
        elif fault == "dx 1% off":
            g[0] = g[0] * 1.01
        elif fault == "one weight gradient 1% off":
            g[4] = g[4] * 1.01
        else:
            raise ValueError(fault)
        return tuple(g)

    ft.TrioFn.backward = staticmethod(backward)
    try:
        yield
    finally:
        ft.TrioFn.backward = staticmethod(real)


def rel_norm_err(got, ref) -> float:
    """||got - ref|| / ||ref|| (0 when both are 0, inf when only ref is)."""
    err, norm = float((got - ref).norm()), float(ref.norm())
    return err / norm if norm > 0 else (0.0 if err == 0 else math.inf)


def gan_readings(ref, got, on_trio_path) -> dict:
    """Readings of one run against the CPU's: logs, first-step gradients,
    parameters (on the elements where the first-step gradient stands above
    rounding, of the tensors whose gradients agree to GRAD_AGREE), u; the
    tensors that filter leaves out; the trio path's worst 2-norm error."""
    (ref_logs, g_ref, sd_ref), (logs, g_got, sd) = ref, got
    read = {"logs": max(abs(lg[k] - rl[k]) / abs(rl[k]) for lg, rl in zip(logs, ref_logs)
                        for k in rl)}
    for side, disc in (("generator", False), ("disc", True)):
        names = [n for n in g_ref if n.startswith(("mpd.", "msd.")) == disc]
        scale = max(float(g_ref[n].abs().max()) for n in names)
        read[side] = max((float((g_got[n] - g_ref[n]).abs().max()) / scale, n) for n in names)
    compared = total = 0
    par, left_out = (0.0, ""), {}
    for n, g in g_ref.items():
        total += g.numel()
        agree = rel_norm_err(g_got[n], g)
        if agree > GRAD_AGREE:
            left_out[n] = agree
            continue
        inside = g.abs() >= 0.1 * g.abs().max()
        compared += int(inside.sum())
        par = max(par, (float((sd[n] - sd_ref[n])[inside].abs().max()), n))
    read.update(par=par, compared=compared, total=total, left_out=left_out,
                left_on_trio_path=sorted(n for n in left_out if n.startswith(on_trio_path)),
                u=max(float((sd[k] - v).abs().max()) for k, v in sd_ref.items()
                      if k.endswith(".u")))
    read["trio_path_worst_agree"] = max((rel_norm_err(g_got[n], g_ref[n]), n)
                                        for n in g_ref if n.startswith(on_trio_path))
    return read


def gan_check_failures(read) -> list[str]:
    out = [k for k in ("logs", "u") if not read[k] <= GAN_CHECK_TOL[k]]
    out += [k for k in ("disc", "generator", "par") if not read[k][0] <= GAN_CHECK_TOL[k]]
    if read["compared"] < read["total"] // 20:
        out.append("compared")
    if not read["trio_path_worst_agree"][0] <= TRIO_PATH_AGREE:
        out.append("trio path")
    return out


def phase_gan_cpu_check(s2, ft, preset) -> None:
    """f32, TF32 off, dropout off on both sides (the generator's
    code_dropout: the card's and the CPU's generators draw other masks): two
    GAN steps of the full-width vocoder and discriminators at B2 x one
    segment on the card (trio kernel under TrioFn) against the same weights
    on the CPU (plain path), two batches, the second after next_epoch.
    Fixed limits (GAN_CHECK_TOL), as tests/test_torch_train_stage2.py holds
    the CPU port against JAX:
    - the logs of both steps, 1e-4 relative;
    - the first step's gradients by name (from Adam's first moments), each
      tensor's largest error over its side's largest element: 1e-5 for the
      discriminators, 2e-4 for the generator (whose upstream gradients
      carry f32 rounding of ~1% where they are ~1e-8 of its largest);
    - parameters after both steps, 2e-5 absolute (a tenth of a step), where
      Adam's first step, lr x sign(g), is not set by rounding: on the
      tensors whose first-step gradients agree with the CPU's to 1e-3 in
      the 2-norm, on their elements whose first-step gradient is at least a
      tenth of the tensor's largest; at least a twentieth of all elements;
      the tensors left out are listed;
    - the gradient of every tensor on the trio's path (the trio stages'
      upsamplers and resblocks), 5e-3 of its own 2-norm, so that a wrong
      gradient in a small tensor shows (sound: up to 1.7e-3, in a weight_g,
      whose gradient is a reduction of dL/dw against v with cancellation;
      the three faulty backwards below: 1e-2 and more);
    - the spectral u, 1e-5.
    Then three faulty TrioFn backwards on the card must each fail it."""
    set_tf32(False)
    cfg = preset("multi_target")
    b1 = cfg.stage2.adam_b1
    step = s2.make_gan_step(cfg)
    batches = [gan_batch(cfg, 2, seed=s) for s in (3, 4)]
    cpu = s2.create_gan_state(cfg, seed=0, device="cpu")
    start = {k: {n: v.clone() for n, v in getattr(cpu, k).state_dict().items()}
             for k in ("generator", "mpd", "msd")}
    sides = {"gen_opt": ("generator",), "disc_opt": ("mpd", "msd")}
    on_trio_path = trio_path(cfg.vocoder)

    def run(state):
        state.generator.code_dropout = 0.0
        logs = []
        for i, batch in enumerate(batches):
            logs.append({k: float(v) for k, v in step(state, batch)[1].items()})
            if i == 0:
                grads = {f"{m}.{n}": getattr(state, opt).state[p]["exp_avg"].to("cpu", copy=True)
                         / (1 - b1) for opt, mods in sides.items() for m in mods
                         for n, p in getattr(state, m).named_parameters()}
                s2.next_epoch(state)
        final = {f"{m}.{n}": v.cpu() for m in start
                 for n, v in getattr(state, m).state_dict().items()}
        return logs, grads, final

    def show(who, read):
        print(f"GAN step f32 B2 {who} vs CPU (2 steps, dropout off): logs {read['logs']:.3e} "
              f"(tol 1e-4); first-step gradients: generator {read['generator'][0]:.3e} at "
              f"{read['generator'][1]} (tol 2e-4), discriminators {read['disc'][0]:.3e} at "
              f"{read['disc'][1]} (tol 1e-5); trio path's gradients, worst 2-norm error "
              f"{read['trio_path_worst_agree'][0]:.3e} at {read['trio_path_worst_agree'][1]} "
              f"(tol {TRIO_PATH_AGREE:g}); parameters on "
              f"{read['compared']} of {read['total']} elements: {read['par'][0]:.3e} at "
              f"{read['par'][1]} (tol 2e-5); u {read['u']:.3e} (tol 1e-5); left out "
              f"{len(read['left_out'])} tensors, on the trio path "
              f"{read['left_on_trio_path'][:4]}{' ...' if len(read['left_on_trio_path']) > 4 else ''}",
              flush=True)

    t0 = time.perf_counter()
    ref = run(cpu)
    print(f"GAN step f32 B2 card vs CPU: CPU steps {time.perf_counter() - t0:.1f} s; logs "
          f"{ref[0][1]}", flush=True)
    card = gan_readings(ref, run(s2.create_gan_state(cfg, state_dicts=start)), on_trio_path)
    show("card", card)
    print("GAN step f32 B2 card: tensors left out of the parameter check (2-norm gradient "
          f"agreement): { {n: f'{v:.2e}' for n, v in sorted(card['left_out'].items())} }",
          flush=True)
    failed = gan_check_failures(card)
    if failed:
        fail(f"the GAN step on the card disagrees with the CPU plain path: {failed}")
    for fault in ("bias gradients dropped", "dx 1% off", "one weight gradient 1% off"):
        with faulty_trio_backward(ft, fault):
            read = gan_readings(ref, run(s2.create_gan_state(cfg, state_dicts=start)),
                                on_trio_path)
        show(f"card, faulty TrioFn backward ({fault})", read)
        caught = gan_check_failures(read)
        print(f"GAN step f32 B2 faulty TrioFn backward ({fault}): fails {caught}", flush=True)
        if not caught:
            fail(f"the card-against-CPU GAN check passed a faulty TrioFn backward ({fault})")
    del cpu, ref
    torch.cuda.empty_cache()


CLI_LENS = (48, 58, 68, 79, 89, 99, 110, 120)    # frames of the 8 clips: buckets 48, 96, 160
# infer's mels and vocode's float waveforms, card against CPU, max |error| /
# max |CPU|: f32_check reads the sound kernels' error at ~1e-6 of that; a
# kernel 0.1% off moves it by ~1e-4 to 1e-3
CLI_REL_TOL = 2e-5
CLI_FAULT = 1 + 1e-3


def write_cli_dataset(root: Path, seed: int = 0) -> Path:
    """A mini dataset tree written with the port's writers: 8 clips of
    48-120 frames as 96x96 uint8 .npy videos, 16 kHz wavs, 256-d speaker
    embeddings, mels of 4 frames and unit rows of 2 units a video frame,
    the .tsv / .unt of all clips and of the two shortest, dict.unt.txt.
    Returns the label directory."""
    from lip2speech_tpu_torch.data.manifest import (Utterance, write_manifest,
                                                    write_unit_dictionary, write_units)
    from lip2speech_tpu_torch.data.video_io import save_video_gray
    from lip2speech_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    utts, rows = [], []
    for i, n in enumerate(CLI_LENS):
        uid = f"spk{i % 2}/clip{i}"
        save_video_gray(root / "video" / f"{uid}.mp4",
                        rng.integers(0, 256, (n, 96, 96), dtype=np.uint8))
        t = np.arange(n * 640) / 16_000
        write_wav(root / "audio" / f"{uid}.wav",
                  0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t) + 0.02 * rng.standard_normal(t.size),
                  16_000)
        for sub, arr in (("spk_emb", rng.standard_normal(256)),
                         ("mel", rng.standard_normal((4 * n, 80)))):
            (root / sub / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
            np.save(root / sub / f"{uid}.npy", arr.astype(np.float32))
        utts.append(Utterance(uid, root / "video" / f"{uid}.mp4", root / "audio" / f"{uid}.wav",
                              n, n * 640))
        rows.append(rng.integers(0, 200, 2 * n))
    label = root / "label"
    write_manifest(label / "all.tsv", root, utts)
    write_units(label / "all.unt", rows)
    write_manifest(label / "short.tsv", root, utts[:2])
    write_units(label / "short.unt", rows[:2])
    write_unit_dictionary(label / "dict.unt.txt")
    return label


def run_counted(counters: dict, fn, expected: dict, what: str):
    """fn() with every launch count set to 0 just before and read just after;
    the counts must be exactly `expected` (kernels not named: 0). Its stdout
    is captured and printed after. Returns (result, seconds, stdout, the
    non-zero counts)."""
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: c.launches for name, c in counters.items()}
    for line in out.getvalue().splitlines():
        print(f"  {what}: {line}", flush=True)
    print(f"{what}: {seconds:.2f} s launches {counts}", flush=True)
    want = {name: expected.get(name, 0) for name in counters}
    if counts != want:
        fail(f"{what}: expected launches {want}, got {counts}")
    return res, seconds, out.getvalue(), {k: n for k, n in counts.items() if n}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}


@contextlib.contextmanager
def scaled_kernel(module, name: str, factor: float):
    """module.<name>, a kernel's wrapper, with its output (the first of a
    tuple) times `factor`: a deliberately faulty kernel, to show that a
    card-against-CPU check sees a fault of that size."""
    real = getattr(module, name)

    def faulty(*args, **kwargs):
        out = real(*args, **kwargs)
        return (out[0] * factor, *out[1:]) if isinstance(out, tuple) else out * factor

    faulty.launches = 0      # the wrapper counts through its module's name, now this one
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, real)


def rel_max_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def infer_mel_err(got_dir: Path, ref_dir: Path) -> float:
    """The worst rel_max_err of the pred_mel files of two infer runs."""
    return max(rel_max_err(np.load(p), np.load(ref_dir / p.relative_to(got_dir)))
               for p in sorted((got_dir / "pred_mel").rglob("*.npy")))


def vocode_wav_err(got: dict, ref: dict) -> float:
    """The worst rel_max_err of two run_vocoder(keep_wavs=True) runs'
    waveforms; they must have the same utterances and lengths."""
    if got.keys() != ref.keys() or any(got[u].shape != ref[u].shape for u in ref):
        fail(f"vocode: waveforms {[(u, w.shape) for u, w in got.items()]} on the card, "
             f"{[(u, w.shape) for u, w in ref.items()]} on the CPU")
    return max(rel_max_err(got[u], ref[u]) for u in ref)


def files_under(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def state_mismatches(got, ref) -> list[str]:
    """Names in a TrainState (model, optimizer, step, both generators) where
    `got` is not bitwise `ref`."""
    bad = [k for k, v in ref.model.state_dict().items()
           if not torch.equal(got.model.state_dict()[k], v)]
    g_opt, r_opt = got.optimizer.state_dict(), ref.optimizer.state_dict()
    if g_opt["state"].keys() != r_opt["state"].keys() or not r_opt["state"]:
        bad.append("optimizer state keys")
    for i, st in r_opt["state"].items():
        for k, v in st.items():
            if not torch.equal(g_opt["state"].get(i, {}).get(k, torch.empty(0)).cpu(), v.cpu()):
                bad.append(f"optimizer {i}.{k}")
    if got.step != ref.step:
        bad.append("step")
    for k in ("gen", "seed_gen"):
        if not torch.equal(getattr(got, k).get_state(), getattr(ref, k).get_state()):
            bad.append(k)
    return bad


def unit_flips_within_ties(cfg, sd, label: Path, gpu_dir: Path, cpu_dir: Path,
                           tol: float = 1e-3) -> tuple[int, int]:
    """Units of the card's run against the CPU's, utterance by utterance:
    where they differ, the card's unit must be within `tol` (f32_check's
    limit on logits) of the CPU's top logit at that position. Returns
    (positions compared, positions that differ); fails otherwise."""
    from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
    from lip2speech_tpu_torch.models.multi_target import MultiTargetModel

    ds = Stage1Dataset(label / "all.tsv", label / "all.unt", train=False)
    n_pos = n_diff = 0
    model = None
    for i, utt in enumerate(ds.utts):
        got = np.array((gpu_dir / "pred_unit" / f"{utt.uid}.txt").read_text().split(), int)
        ref = np.array((cpu_dir / "pred_unit" / f"{utt.uid}.txt").read_text().split(), int)
        if got.shape != ref.shape:
            fail(f"infer: {utt.uid} has {got.shape} units on the card, {ref.shape} on the CPU")
        n_pos += ref.size
        diff = np.flatnonzero(got != ref)
        n_diff += diff.size
        if not diff.size:
            continue
        if model is None:
            model = MultiTargetModel(cfg.model)
            model.load_state_dict(sd, strict=True)
            model.eval()
        s = ds.collate([ds.load(i)])
        with torch.inference_mode():
            logits = model(*(torch.as_tensor(s[k]) for k in ("video", "frames_mask", "spk_emb")))[
                "unit_logits"][0, :, cfg.model.units.num_special:]
        top = logits.max(-1).values
        gap = (top[diff] - logits[diff, torch.as_tensor(got[diff])]).abs()
        print(f"infer: {utt.uid} units differ at {diff.size} positions, CPU logit gap "
              f"{gap.max().item():.3e}", flush=True)
        if not bool((gap <= tol).all()):
            fail(f"infer: {utt.uid} units differ beyond a near-tie ({gap.max().item():.3e})")
    return n_pos, n_diff


def phase_cli(syn, counters: dict, preset) -> dict:
    """The command-line tools at the full width of multi_target on the card,
    through their entry points, in a temporary directory removed after:
    train_stage1 (2 updates, then --resume to 3) with exact launches per
    update and a bitwise restore of s1_00000002; infer from s1_00000003
    against the same call on the CPU; synthesise_file (bf16) with a random
    vocoder; train_stage2 (one epoch, then --resume for a second) with 4
    trio launches a step; vocode from the last g_ against the CPU. infer and
    vocode are also run with a kernel 0.1% off, which their checks must
    fail. Returns the launches of each kernel by tool."""
    from lip2speech_tpu_torch.cli import infer, train_stage1, train_stage2, vocode
    from lip2speech_tpu_torch.convert.from_reference import (load_generator_weights,
                                                             load_stage1_weights)
    from lip2speech_tpu_torch.data.stage1 import pick_bucket
    from lip2speech_tpu_torch.models.layers import init_weights
    from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator
    from lip2speech_tpu_torch.ops import fused_tail as ft
    from lip2speech_tpu_torch.ops import rel_attention as ra
    from lip2speech_tpu_torch.train import checkpoint as ckpt
    from lip2speech_tpu_torch.train import stage1 as s1

    torch.backends.cuda.matmul.allow_tf32 = False       # torch's defaults for training
    torch.backends.cudnn.allow_tf32 = True
    cfg = preset("multi_target")
    layers, n_trio = cfg.model.conformer.layers, n_trio_stages(cfg.vocoder)
    seconds, launches, sizes = {}, {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        label = write_cli_dataset(tmp / "data")
        tsv, unt = str(label / "all.tsv"), str(label / "all.unt")
        s1_dir, s2_dir = tmp / "s1", tmp / "s2"

        # stage-1 training: 2 micro-batches of 4 per update, 12 layers each
        s1_args = ["--preset", "multi_target", "--train-tsv", tsv, "--train-unt", unt,
                   "--checkpoint-dir", str(s1_dir), "--batch-size", "4", "--update-freq", "2",
                   "--save-interval", "1", "--log-interval", "1"]
        per_update = {"rel_attention": 2 * layers, "rel_attention_bwd": 2 * layers}
        state, t1, _, c1 = run_counted(
            counters, lambda: train_stage1.main(s1_args + ["--max-updates", "2"]),
            {k: 2 * v for k, v in per_update.items()}, "train_stage1 --max-updates 2")
        t0 = time.perf_counter()
        fresh = s1.create_train_state(cfg, seed=7)
        ckpt.load_stage1(s1_dir / "s1_00000002.pt", fresh)
        bad = state_mismatches(fresh, state)
        n_opt = sum(len(v) for v in state.optimizer.state_dict()["state"].values())
        print(f"train_stage1: s1_00000002.pt restored into a fresh state on the card in "
              f"{time.perf_counter() - t0:.2f} s: {len(state.model.state_dict())} model tensors, "
              f"{n_opt} optimizer entries, step {fresh.step}, both generators; not bitwise: "
              f"{bad or 'none'}", flush=True)
        if bad or fresh.step != 2 or fresh.device.type != "cuda":
            fail(f"train_stage1: the restored state differs from the saved one: {bad}")
        # resume below from s1_00000002 rewritten as a CPU run or a converted
        # JAX run would leave it: a CPU generator's state, none for seed_gen
        content = ckpt.stage1_content(fresh)
        content["gen"] = ckpt.generator_state(torch.Generator().manual_seed(3))
        del content["seed_gen"]
        ckpt.save(s1_dir / "s1_00000002.pt", content)
        del state, fresh, content
        torch.cuda.empty_cache()
        state, t2, out, c2 = run_counted(
            counters, lambda: train_stage1.main(s1_args + ["--max-updates", "3", "--resume"]),
            per_update, "train_stage1 --resume --max-updates 3")
        if "resumed from update 2" not in out or state.step != 3:
            fail(f"train_stage1 --resume: did not resume from update 2 (step {state.step})")
        del state
        torch.cuda.empty_cache()
        seconds["train_stage1"] = t1 + t2
        launches["train_stage1"] = add_counts(c1, c2)
        sizes.update({p.name: p.stat().st_size for p in sorted(s1_dir.glob("s1_*.pt"))})

        # inference from the last checkpoint: the card, f32 and TF32 off, against the CPU
        set_tf32(False)
        sd = load_stage1_weights(s1_dir / "s1_00000003.pt", cfg.model)
        n_batches = sum(-(-c // 4) for c in Counter(pick_bucket(n) for n in CLI_LENS).values())
        stats, seconds["infer"], _, launches["infer"] = run_counted(
            counters,
            lambda: infer.run_inference(cfg, sd, tsv, unt, tmp / "infer_gpu", batch_size=4),
            {"rel_attention": layers * n_batches}, "infer.run_inference")
        t0 = time.perf_counter()
        stats_cpu = infer.run_inference(cfg, sd, tsv, unt, tmp / "infer_cpu", batch_size=4,
                                        device="cpu")
        cpu_s = time.perf_counter() - t0
        gpu_files, cpu_files = files_under(tmp / "infer_gpu"), files_under(tmp / "infer_cpu")
        mel_err = infer_mel_err(tmp / "infer_gpu", tmp / "infer_cpu")
        n_pos, n_diff = unit_flips_within_ties(cfg, sd, label, tmp / "infer_gpu", tmp / "infer_cpu")
        with scaled_kernel(ra, "rel_attention_kernel", CLI_FAULT):
            infer.run_inference(cfg, sd, tsv, unt, tmp / "infer_faulty", batch_size=4)
        faulty_err = infer_mel_err(tmp / "infer_faulty", tmp / "infer_cpu")
        print(f"infer: {stats['n_utts']} utterances, n_failed {stats['n_failed']}, WER "
              f"{stats['wer']:.2f} (CPU {stats_cpu['wer']:.2f}); {len(gpu_files)} files; mel "
              f"error vs CPU {mel_err:.3e} of max |mel| (tol {CLI_REL_TOL:g}), with "
              f"rel_attention {CLI_FAULT - 1:.1%} off {faulty_err:.3e}; units differ at "
              f"{n_diff} of {n_pos} positions (near-ties only); CPU run {cpu_s:.2f} s", flush=True)
        if (stats["n_failed"] or stats["n_utts"] != len(CLI_LENS) or gpu_files != cpu_files
                or len(gpu_files) != 2 * len(CLI_LENS) + 2 or not mel_err <= CLI_REL_TOL):
            fail("infer: the card's artifacts disagree with the CPU's")
        if faulty_err <= CLI_REL_TOL:
            fail("infer: the check passes a rel_attention 0.1% off")

        # one file through the serving call, bf16, with a random vocoder
        voc = MelCodeGenerator(cfg.vocoder)
        init_weights(voc, torch.Generator().manual_seed(1))
        pipe = syn.Lip2SpeechPipeline(cfg, sd, voc.state_dict(), compute_dtype=torch.bfloat16)
        clip = label.parent / "video" / "spk1" / "clip1.mp4"
        spk = np.load(label.parent / "spk_emb" / "spk1" / "clip1.npy")
        pipe.synthesise_file(clip, spk)                 # cuDNN picks its algorithms
        res, seconds["synthesise_file"], _, launches["synthesise_file"] = run_counted(
            counters, lambda: pipe.synthesise_file(clip, spk),
            {"rel_attention": layers, "fused_resblock_trio": n_trio}, "synthesise_file bf16")
        n = CLI_LENS[1]
        print(f"synthesise_file: {n} frames -> wav {res.wav.shape} {res.wav.dtype}, units "
              f"{res.units.shape}, |wav| max {float(np.abs(res.wav).max()):.4f}", flush=True)
        if (res.wav.shape != (640 * n,) or not np.isfinite(res.wav).all()
                or res.units.shape != (2 * n,)):
            fail("synthesise_file: bad result")
        del pipe, voc, sd
        torch.cuda.empty_cache()

        # stage-2 GAN training: 8 clips at batch 4, 2 steps an epoch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        s2_args = ["--preset", "multi_target", "--train-tsv", tsv, "--train-unt", unt,
                   "--checkpoint-dir", str(s2_dir), "--batch-size", "4", "--log-interval", "1"]
        gan, t1, _, c1 = run_counted(
            counters, lambda: train_stage2.main(s2_args + ["--epochs", "1"]),
            {"fused_resblock_trio": 2 * n_trio}, "train_stage2 --epochs 1")
        if (gan.step, gan.epoch) != (2, 1):
            fail(f"train_stage2: step {gan.step} epoch {gan.epoch} after one epoch")
        del gan
        gan, t2, out, c2 = run_counted(
            counters, lambda: train_stage2.main(s2_args + ["--epochs", "2", "--resume"]),
            {"fused_resblock_trio": 2 * n_trio}, "train_stage2 --resume --epochs 2")
        if "resumed from step 2, epoch 1" not in out or (gan.step, gan.epoch) != (4, 2):
            fail(f"train_stage2 --resume: step {gan.step} epoch {gan.epoch}")
        del gan
        torch.cuda.empty_cache()
        names = sorted(p.name for p in s2_dir.iterdir() if p.is_file())
        if names != ["do_00000002", "do_00000004", "g_00000002", "g_00000004"]:
            fail(f"train_stage2: checkpoint files {names}")
        seconds["train_stage2"] = t1 + t2
        launches["train_stage2"] = add_counts(c1, c2)
        sizes.update({name: (s2_dir / name).stat().st_size for name in names})

        # vocode the two shortest clips from the last g_: the card in f32, TF32 off, against the CPU
        set_tf32(False)
        gen_sd = load_generator_weights(s2_dir / "g_00000004", cfg.vocoder)
        vtsv, vunt = label / "short.tsv", label / "short.unt"
        vstats, seconds["vocode"], _, launches["vocode"] = run_counted(
            counters, lambda: vocode.run_vocoder(cfg, gen_sd, vtsv, vunt, tmp / "voc_gpu",
                                                 keep_wavs=True),
            {"fused_resblock_trio": 2 * n_trio}, "vocode.run_vocoder")
        t0 = time.perf_counter()
        ref_wavs = vocode.run_vocoder(cfg, gen_sd, vtsv, vunt, tmp / "voc_cpu", device="cpu",
                                      keep_wavs=True)["wavs"]
        cpu_s = time.perf_counter() - t0
        wav_err = vocode_wav_err(vstats.pop("wavs"), ref_wavs)
        with scaled_kernel(ft, "fused_resblock_trio_kernel", CLI_FAULT):
            faulty = vocode.run_vocoder(cfg, gen_sd, vtsv, vunt, tmp / "voc_faulty",
                                        keep_wavs=True)["wavs"]
        faulty_err = vocode_wav_err(faulty, ref_wavs)
        wav_files = files_under(tmp / "voc_gpu")
        print(f"vocode: {vstats}; float wav error vs CPU {wav_err:.3e} of max |wav| (tol "
              f"{CLI_REL_TOL:g}), with the trio {CLI_FAULT - 1:.1%} off {faulty_err:.3e}; |wav| "
              f"max {max(float(np.abs(w).max()) for w in ref_wavs.values()):.4f}; CPU run "
              f"{cpu_s:.2f} s", flush=True)
        if (vstats["n_utts"] != 2 or wav_files != files_under(tmp / "voc_cpu")
                or len(wav_files) != 2 or not wav_err <= CLI_REL_TOL):
            fail("vocode: the card's waveforms disagree with the CPU's")
        if faulty_err <= CLI_REL_TOL:
            fail("vocode: the check passes a trio 0.1% off")
    seconds["phase"] = time.perf_counter() - t_phase
    summary = {"seconds": {k: round(v, 3) for k, v in seconds.items()}, "launches": launches,
               "checkpoint_bytes": sizes}
    print(f"phase 18 command-line tools (multi_target, full width): {json.dumps(summary)}",
          flush=True)
    return launches

# phase 19: the serving process
SERVE_LENS = (96, 90, 80, 61)     # batcher: one bucket (96), so one group and one device call
VSG_FRAMES = 750                  # 30 s: segments of 587 and 163 frames, buckets 600 and 240
RAW_FRAMES = 24
SERVE_PCM_TOL = 1                 # PCM16 steps, HTTP against the direct call
BATCHER_PCM_TOL = 2               # PCM16 steps, a batch-4 row against its batch-1 request
DEVICE_OP_TOL = {"warp": 1e-3, "embed": 1e-4, "denoise": 1e-4}   # card vs CPU, of max |ref|


def face_video(t: int, seed: int = 0, h: int = 240, w: int = 320, size: int = 96) -> np.ndarray:
    """(t, h, w) uint8 raw frames: a light size x size head on mid-gray with
    eyes, a nose and a mouth that opens and closes, sensor noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy, r = w / 2, h / 2, size / 2
    head = ((xx - cx) / (0.85 * r)) ** 2 + ((yy - cy) / r) ** 2 <= 1.0
    eyes = np.zeros((h, w), bool)
    for ex in (cx - 0.35 * r, cx + 0.35 * r):
        eyes |= ((xx - ex) / (0.16 * r)) ** 2 + ((yy - (cy - 0.25 * r)) / (0.08 * r)) ** 2 <= 1.0
    nose = (np.abs(xx - cx) < 0.05 * r) & (yy > cy - 0.2 * r) & (yy < cy + 0.2 * r)
    frames = np.empty((t, h, w), np.uint8)
    for i in range(t):
        img = np.full((h, w), 120.0, np.float32)
        img[head], img[eyes], img[nose] = 190.0, 70.0, 140.0
        opening = (0.06 + 0.05 * np.sin(2 * np.pi * i / 12)) * r
        img[(np.abs(xx - cx) < 0.33 * r) & (np.abs(yy - (cy + 0.55 * r)) < opening)] = 35.0
        frames[i] = np.clip(img + rng.normal(0, 2.0, (h, w)), 0, 255)
    return frames


def http(port: int, method: str, path: str, body=None, headers=None, timeout: float = 120.0):
    """One request to the server on this host: (status, decoded JSON)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if isinstance(body, dict) else body
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def pcm16(out: dict) -> np.ndarray:
    import base64
    import wave

    with wave.open(io.BytesIO(base64.b64decode(out["wav_base64"]))) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def quantised(wav: np.ndarray) -> np.ndarray:
    """The server's PCM16 (server._wav_base64)."""
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16)


def pcm_diff(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        fail(f"PCM16 lengths differ: {a.shape} vs {b.shape}")
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def phase_serving(syn, counters: dict, preset) -> dict:
    """The port's HTTP server on a thread of this process (make_server(port
    =0)), spoken to over HTTP: full-width multi_target, random weights from
    seed 0, pipelines "f32" (the server's default dtype) and "bf16" (--bf16).
    Exact launch counts per request, every response against the direct call.
    Returns the server's launches per kernel and request kind."""
    import threading

    from lip2speech_tpu_torch.data.stage1 import pick_bucket
    from lip2speech_tpu_torch.models.speaker import SpeakerEncoder, embed_utterance
    from lip2speech_tpu_torch.ops import denoise, warp
    from lip2speech_tpu_torch.pipeline import landmarks, mouth_crop
    from lip2speech_tpu_torch.pipeline import server as srv
    from lip2speech_tpu_torch.utils.audio_io import write_wav

    t_phase = time.perf_counter()
    set_tf32(False)                   # f32 is f32 (as phase 18 leaves it)
    cfg = preset("multi_target")
    one = {"rel_attention": cfg.model.conformer.layers,
           "fused_resblock_trio": n_trio_stages(cfg.vocoder)}
    two = {k: 2 * n for k, n in one.items()}
    f32 = syn.Lip2SpeechPipeline.initialize_random(cfg, seed=0)
    bf16 = syn.Lip2SpeechPipeline(cfg, f32.model.state_dict(), f32.vocoder.state_dict(),
                                  compute_dtype=torch.bfloat16)
    f32.warmup(buckets=(96, 240, 600))
    f32.warmup(buckets=(96,), batch_sizes=(4,))
    bf16.warmup(buckets=(96,))
    torch.manual_seed(0)
    encoder = SpeakerEncoder().cuda()
    print(f"serving: pipelines built and warmed in {time.perf_counter() - t_phase:.1f} s; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    rng = np.random.default_rng(19)
    launches, diffs, read = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        clip = rng.integers(0, 256, (96, 96, 96), dtype=np.uint8)
        np.save(tmp / "clip.npy", clip)
        long = rng.integers(0, 256, (VSG_FRAMES, 96, 96), dtype=np.uint8)
        np.save(tmp / "long.npy", long)
        for n in SERVE_LENS:
            np.save(tmp / f"b{n}.npy", rng.integers(0, 256, (n, 96, 96), dtype=np.uint8))
        raw = face_video(RAW_FRAMES)
        np.save(tmp / "raw.npy", raw)
        spk_wav = (0.3 * rng.standard_normal(48_000)).astype(np.float32)
        write_wav(tmp / "spk.wav", spk_wav, 16_000)
        servers = {
            "main": srv.make_server(0, pipelines={"f32": f32, "bf16": bf16},
                                    inputs_dir=str(tmp / "in_main")),
            "batcher": srv.make_server(0, pipelines={"f32": f32}, use_batcher=True, max_batch=4,
                                       max_wait_ms=2000.0, inputs_dir=str(tmp / "in_batcher")),
            "raw": srv.make_server(0, pipelines={"bf16": bf16}, speaker_encoder=encoder,
                                   postprocess=True, inputs_dir=str(tmp / "in_raw"))}
        port = {name: s.server_address[1] for name, s in servers.items()}
        threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers.values()]
        for th in threads:
            th.start()
        state = servers["main"].RequestHandlerClass.state
        spk = state.default_spk_emb
        try:
            code, health = http(port["main"], "GET", "/health")
            _, ckpts = http(port["main"], "GET", "/checkpoints")
            print(f"serving: /health {code} {health}; /checkpoints {ckpts}", flush=True)
            if health["devices"] != [torch.cuda.get_device_name(0)] or ckpts["checkpoints"] != [
                    "bf16", "f32"]:
                fail("serving: /health does not name the card or /checkpoints lacks a pipeline")

            def post(name, path, body, expected, what):
                (code, out), _, _, counts = run_counted(
                    counters, lambda: http(port[name], "POST", path, body), expected, what)
                if code != 200:
                    fail(f"{what}: status {code} {out}")
                return out, counts

            # /synthesise, B1 x 96, both dtypes through ?cid=, against the direct call
            direct = {}
            for dt in ("f32", "bf16"):
                out, launches[f"synthesise_{dt}"] = post(
                    "main", f"/synthesise?cid={dt}", {"video_path": str(tmp / "clip.npy")}, one,
                    f"/synthesise?cid={dt} B1x96")
                direct[dt] = quantised(srv._synthesise_frames(state, clip, spk, dt))
                diffs[f"synthesise_{dt}"] = pcm_diff(pcm16(out), direct[dt])
            if pcm_diff(direct["f32"], direct["bf16"]) == 0:
                fail("serving: the f32 and bf16 pipelines answer alike: ?cid= did not switch")
            # hot swap: the active pipeline is "bf16" (first by name); load "f32"
            code, out = http(port["main"], "POST", "/load_checkpoint", {"name": "f32"})
            if code != 200 or out["active"] != "f32":
                fail(f"serving: /load_checkpoint {code} {out}")
            swapped, _ = post("main", "/synthesise", {"video_path": str(tmp / "clip.npy")}, one,
                              "/synthesise after /load_checkpoint f32")
            diffs["load_checkpoint"] = pcm_diff(pcm16(swapped), direct["f32"])

            # /vsg/synthesise of 30 s: two segments; then the same bytes through /dzupload
            out, launches["vsg"] = post("main", "/vsg/synthesise?cid=f32",
                                        {"video_path": str(tmp / "long.npy")}, two,
                                        f"/vsg/synthesise {VSG_FRAMES} frames")
            vsg_ref = quantised(srv.synthesise_long_video(state, long, spk, "f32"))
            diffs["vsg"] = pcm_diff(pcm16(out), vsg_ref)
            data = (tmp / "long.npy").read_bytes()
            size = 1_000_000
            offsets = list(range(0, len(data), size))
            order = list(range(len(offsets)))[::-1]
            for n, i in enumerate(order):
                q = (f"/dzupload?id=vsg1&filename=long.npy&dzchunkbyteoffset={offsets[i]}"
                     f"&dzchunkindex={i}&dztotalchunkcount={len(offsets)}"
                     f"&dztotalfilesize={len(data)}")
                code, out = http(port["main"], "POST", q, data[offsets[i]: offsets[i] + size],
                                 {"Content-Type": "application/octet-stream"})
                if code != 200 or out["complete"] != (n == len(order) - 1):
                    fail(f"serving: /dzupload chunk {i}: {code} {out}")
            out, launches["vsg_dzupload"] = post("main", "/vsg/synthesise?cid=f32",
                                                 {"upload_id": "vsg1"}, two,
                                                 f"/vsg/synthesise of {len(offsets)} chunks "
                                                 f"uploaded last first")
            diffs["vsg_dzupload"] = pcm_diff(pcm16(out), vsg_ref)

            # /vocode from the direct call's units and mel
            res = f32.synthesise_batch(*request(cfg, 1, 96, (96,), seed=19)[:2], spk[None])[0]
            np.save(tmp / "mel.npy", res.mel)
            out, launches["vocode"] = post("main", "/vocode?cid=f32",
                                           {"units": res.units.tolist(),
                                            "mel_path": str(tmp / "mel.npy")},
                                           {"fused_resblock_trio": one["fused_resblock_trio"]},
                                           "/vocode 192 units")
            n = len(res.units)
            tc = 2 * pick_bucket((n + 1) // 2)
            code_b = np.zeros((1, tc), np.int32)
            code_b[0, :n] = res.units
            mel_b = np.zeros((1, 2 * tc, res.mel.shape[1]), np.float32)
            mel_b[0, : len(res.mel)] = res.mel
            voc_ref = quantised(f32.vocode(code_b, mel_b, spk[None])[0, : n * 320])
            diffs["vocode"] = pcm_diff(pcm16(out), voc_ref)

            # --batcher: 4 concurrent requests of one bucket -> one group, one device call
            unbatched = {}
            for n in SERVE_LENS:
                code, out = http(port["main"], "POST", "/synthesise?cid=f32",
                                 {"video_path": str(tmp / f"b{n}.npy")})
                unbatched[n] = pcm16(out)
            answers = {}

            def one_request(n):
                answers[n] = http(port["batcher"], "POST", "/synthesise",
                                  {"video_path": str(tmp / f"b{n}.npy")})

            def concurrent():
                workers = [threading.Thread(target=one_request, args=(n,)) for n in SERVE_LENS]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(120)

            _, batch_s, _, launches["batcher_group_of_4"] = run_counted(
                counters, concurrent, one, "--batcher: 4 concurrent requests (96/90/80/61)")
            batch_diffs = {}
            for n in SERVE_LENS:
                code, out = answers.get(n, (None, None))
                if code != 200:
                    fail(f"--batcher: request of {n} frames: {code} {out}")
                batch_diffs[n] = pcm_diff(pcm16(out), unbatched[n])
            diffs["batcher"] = max(batch_diffs.values())
            read["batcher_pcm_diff_by_frames"] = batch_diffs
            read["batcher_seconds"] = batch_s

            # the raw-video path: landmarks on the host, the mouth crop, the
            # speaker encoder and the denoiser on the card
            provider = landmarks.default_landmarker()
            t0 = time.perf_counter()
            lms = provider(raw)
            read["landmarker"] = type(provider).__name__
            read["landmarks_s"] = time.perf_counter() - t0
            detected = sum(lm is not None for lm in lms)
            mean = mouth_crop.default_mean_face()
            mats, centers = warp.crop_transforms(lms, mean)
            args = [np.asarray(a, np.float32) for a in (raw, mats, centers)]
            on_card = warp.warp_crop_batch(*(torch.from_numpy(a).cuda() for a in args)).cpu()
            on_cpu = warp.warp_crop_batch(*(torch.from_numpy(a) for a in args))
            read["warp_err"] = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
            dev_crop = warp.crop_mouth_sequence_device(raw, lms, mean)
            host_crop = mouth_crop.crop_mouth_sequence(raw, lms, mean)
            steps = np.abs(dev_crop.astype(int) - host_crop.astype(int))
            read["warp_vs_host_crop"] = {"max_levels": int(steps.max()),
                                         "share_within_1": float((steps <= 1).mean())}
            enc_cpu = SpeakerEncoder()
            enc_cpu.load_state_dict({k: v.cpu() for k, v in encoder.state_dict().items()})
            emb_ref = embed_utterance(enc_cpu, spk_wav)
            read["embed_err"] = float(np.abs(embed_utterance(encoder, spk_wav) - emb_ref).max()
                                      / np.abs(emb_ref).max())
            wav = srv._synthesise_frames(state, clip, spk, "f32")
            den_ref = denoise.preprocess_audio(torch.from_numpy(wav)).numpy()
            den = denoise.preprocess_audio(torch.from_numpy(wav).cuda()).cpu().numpy()
            read["denoise_err"] = float(np.abs(den - den_ref).max() / np.abs(den_ref).max())
            out, launches["raw_video"] = post("raw", "/synthesise?close_up=0",
                                              {"video_path": str(tmp / "raw.npy"),
                                               "spk_wav_path": str(tmp / "spk.wav")}, one,
                                              f"/synthesise?close_up=0 raw {RAW_FRAMES} frames "
                                              f"(+ speaker wav, postprocess)")
            raw_pcm = pcm16(out)
            print(f"serving raw video: {read['landmarker']} found {detected}/{RAW_FRAMES} "
                  f"faces in {read['landmarks_s']:.2f} s; warp card vs CPU {read['warp_err']:.3e} "
                  f"of max (tol {DEVICE_OP_TOL['warp']:g}); device crop vs host crop "
                  f"{read['warp_vs_host_crop']}; embed_utterance card vs CPU "
                  f"{read['embed_err']:.3e} (tol {DEVICE_OP_TOL['embed']:g}); preprocess_audio "
                  f"card vs CPU {read['denoise_err']:.3e} (tol {DEVICE_OP_TOL['denoise']:g}); "
                  f"response {len(raw_pcm)} samples, peak {int(np.abs(raw_pcm).max())}",
                  flush=True)
            if (detected < RAW_FRAMES // 2 or dev_crop.shape != (RAW_FRAMES, 96, 96)
                    or read["warp_vs_host_crop"]["max_levels"] > 2
                    or read["warp_vs_host_crop"]["share_within_1"] < 0.99
                    or len(raw_pcm) != RAW_FRAMES * 640
                    or not 0.9 * 32767 < np.abs(raw_pcm).max() <= 0.96 * 32767
                    or any(read[f"{k}_err"] > tol for k, tol in DEVICE_OP_TOL.items())):
                fail("serving: the raw-video path disagrees")

            # HTTP and host overhead at bf16 B1x96: 10 requests as the server
            # ships (device calls on its one device thread) and, in turns, 10
            # with the device call made in each request's own new thread (as
            # the JAX server makes it); the handler's own time (elapsed_s);
            # then 10 direct calls
            http_ms, handler_ms, direct_ms = {"device_thread": [], "handler_thread": []}, [], []
            for kind in ("device_thread", "handler_thread", "handler_thread", "device_thread"):
                if kind == "handler_thread":
                    state.on_device = lambda fn, *a: fn(*a)
                for _ in range(5):
                    t0 = time.perf_counter()
                    code, out = http(port["main"], "POST", "/synthesise?cid=bf16",
                                     {"video_path": str(tmp / "clip.npy")})
                    http_ms[kind].append((time.perf_counter() - t0) * 1e3)
                    if code != 200:
                        fail(f"serving: p50 request status {code}")
                    if kind == "device_thread":
                        handler_ms.append(out["elapsed_s"] * 1e3)
                vars(state).pop("on_device", None)          # the class's own again
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                srv._synthesise_frames(state, clip, spk, "bf16")
                torch.cuda.synchronize()
                direct_ms.append((time.perf_counter() - t0) * 1e3)
            busy, shares = {}, {}
            for dt in ("bf16", "f32"):
                by_name = {}
                busy[dt] = profile_call(lambda: srv._synthesise_frames(state, clip, spk, dt),
                                        f"serving direct B1x96 {dt}", top=6, by_name=by_name)
                shares[dt] = {k: sum(ms for name, ms in by_name.items() if k in name) / busy[dt]
                              for k in ("rel_attention", "trio_")}
            read.update(http_p50_ms=float(np.median(http_ms["device_thread"])),
                        http_min_ms=min(http_ms["device_thread"]),
                        http_handler_thread_p50_ms=float(np.median(http_ms["handler_thread"])),
                        handler_p50_ms=float(np.median(handler_ms)),
                        direct_p50_ms=float(np.median(direct_ms)), direct_min_ms=min(direct_ms),
                        busy_ms=busy, kernel_share_of_busy=shares)
            code, out = http(port["main"], "POST", "/synthesise",
                             {"video_path": str(tmp / "missing.npy")})
            code_after, _ = http(port["main"], "POST", "/synthesise?cid=bf16",
                                 {"video_path": str(tmp / "clip.npy")})
            read["bad_video_path"] = [code, code_after]
            if (code, code_after) != (400, 200):
                fail(f"serving: a bad video_path gave {code}, the next request {code_after}")
        finally:
            for s in servers.values():
                s.shutdown()
                s.server_close()
                s.RequestHandlerClass.state.close()
            for th in threads:
                th.join(60)
    read["pcm_diffs"] = diffs
    bad = {k: d for k, d in diffs.items()
           if d > (BATCHER_PCM_TOL if k == "batcher" else SERVE_PCM_TOL)}
    if bad:
        fail(f"serving: responses differ from the direct calls by {bad} PCM16 steps "
             f"(tol {SERVE_PCM_TOL}, batcher {BATCHER_PCM_TOL})")
    read["launches"] = launches
    read["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"serving": read}), flush=True)
    del f32, bf16, encoder
    torch.cuda.empty_cache()
    return {kernel: {kind: counts.get(kernel, 0) for kind, counts in launches.items()}
            for kernel in one}


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
    from lip2speech_tpu_torch.models import vocoder as voc
    from lip2speech_tpu_torch.train import stage1 as s1
    from lip2speech_tpu_torch.train import stage2 as s2

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
    hmma, hmma_tf32 = sass_tensor_core_counts(build)

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
    flagship_launches = {"attention": flagship.model.frontend.encoder_layers,
                         "rel_attention": flagship.model.conformer.layers,
                         "fused_resblock_trio": n_trio}
    launches = phase_pipeline(syn, counters, "multi_target_avhubert", flagship, flagship_launches)
    plain["flagship_f32_request"] = phase_f32_request(syn, counters, "multi_target_avhubert",
                                                      flagship, flagship_launches)
    phase_units(ue, km, counters)
    phase_other_frontends(syn, counters, preset)
    shear_bwd, bias_bwd = phase_attention_bwd(ra, dev)
    dropout_ms = phase_dropout(ra, dm, dev)
    train_launches = phase_train(s1, counters, preset)
    train_shape = "B{}H{}T{}".format(*TRAIN_SHAPE)
    f32_steps = phase_train_f32(s1, counters, preset, 2 * cfg.model.conformer.layers * (
        bias["f32"][train_shape]["bias_build_ms"] + bias_bwd["f32"][train_shape]["bias_autograd_ms"]))
    rel["train_f32_step"], bias["train_f32_step"] = f32_steps["shear"], f32_steps["bias"]
    phase_train_f32_check(s1, preset)
    phase_train_flagship(s1, counters, preset)
    trio["gan_f32"] = phase_trio_gan(ft, dev, cfg.vocoder, cfg.stage2.batch_size)
    phase_trio_fn(ft, voc, dev, cfg.vocoder)
    trio.update(phase_gan_step(s2, voc, ft, counters, preset))
    phase_gan_cpu_check(s2, ft, preset)
    cli = phase_cli(syn, counters, preset)
    served = phase_serving(syn, counters, preset)
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
        f32_design = ("3xTF32 mma.sync m16n8k8, f32 accumulate" if lib in TF32_KERNELS
                      else "FMA")
        numbers.update(design=f"mma.sync m16n8k16 bf16, f32 accumulate; f32: {f32_design}",
                       hmma_in_sass=hmma[lib], hmma_tf32_in_sass=hmma_tf32[lib],
                       cli_launches={tool: n[name] for tool, n in cli.items() if name in n},
                       server_launches=served.get(name, {}))
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
