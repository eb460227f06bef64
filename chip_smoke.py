#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lip2speech_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from lip2speech_tpu_torch/csrc (nvcc, in parallel);
     print ptxas's registers and spills of every kernel (each f32 and bf16
     instantiation), and count the tensor-core instructions in each
     library's SASS, warp-level (HMMA, mma.sync) and warpgroup (HGMMA,
     wgmma) apart, the TF32 ones of each apart, and its generic loads and
     stores (LD.E / ST.E: a shared access that lost the shared space): no
     HGMMA or no TF32 HGMMA in rel_attention, attention, rel_attention_bias
     (the three forwards: every product on wgmma), rel_attention_bwd,
     rel_attention_bias_bwd (the key-major backwards: wgmma; f32 in 3xTF32)
     and fused_tail (the trio: every conv on wgmma), any HMMA in fused_tail
     or rel_attention_bias, or any generic access in fused_tail,
     rel_attention_bias or rel_attention_bias_bwd, fails;
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
     at B4 H16 T240, at the flagship train step's B8 H16 T600 and at a full
     unit-extraction chunk's B1 H12 T4999, beside SDPA and the bound; the f32 path (3xTF32) within ATTENTION_F32_TOL = 3e-5 of
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
     backward (the shear route's with the float bias requiring grad, the
     library_ms, and without) and the bound (bytes and operations), the bias route's also
     beside the autograd of the bias construction (its SDPA backward too
     with the bias requiring grad, the library_ms, and without); the shear backward's f32
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
 20. lip-reading recognition at the CLI's full width, the decoders cut
     from 6 layers to 2, random weights, f32 (TF32 off), beam 10, 50
     steps, char vocabulary: AV-HuBERT seq2seq (encoder 1024 x 24, decoder
     1024 x 2) at B1 x 96 and B4 ragged (96/80/64/50), alone and with a
     6-layer LM (512 / 8 / 2048) fused at 0.3; RAVEn (conformer 1024 x 24,
     decoder 1024 x 2) with the joint CTC/attention search at CTC weight
     0.1 at both shapes. Each decode: exact launches (attention
     24 or rel_attention 24 a decode, every other kernel 0), the encoder
     states against the same weights' CPU run (ASR_ENC_TOL), the card's
     n-best teacher-forced on the CPU (ASR_SCORE_TOL), p50 of 5 calls, one
     profiled call (busy ms and share, launches a decode), and at B1 whether
     the n-best equals the CPU search's (printed, not gated). Then infer_asr
     in both modes on 4 synthetic clips, hypo.json against the direct decode
     of the same batch on the card. Prints one "asr" JSON line.
 21. multi-GPU on the one card (parallel/, the data- and tensor-parallel
     steps, data-parallel serving), f32 with TF32 off and cuDNN's
     deterministic algorithms, dropout 0: at world
     size 1 over NCCL in this process, the data-parallel stage-1 step of
     multi_target at 4 x 600 x 2 and the GAN step at 16 x 8,960 against
     the single-card steps on the same state and batch (bit for bit, or,
     where the card does not repeat the single-card step bit for bit
     itself, shown by a twin run, within the limits below), exact launches (rel_attention and rel_attention_bwd 24 a
     step, the trio 4), p50 of 3 each; a one-device serving mesh against
     the plain call (PCM16 equal). Then two ranks sharing the card over
     gloo (FileStore, CUDA tensors), against the single-process steps:
     DP2 (2 + 2 rows), DP1 x TP2 (4 heads a rank) and a TP2 step of
     multi_target_avhubert at 1 x 240 (attention 24 launches a rank on 8
     heads, rel_attention 12), then the GAN step with 8 + 8 rows; gradients
     by name within 1e-4 of the step's largest element and in the 2-norm
     of the whole gradient's (phase 13's pair: ReLU gates within rounding
     of 0 flip between batch sizes), or within ten times the worst that a
     twin of the single-card step from weights one ulp away reads (phase
     13's rule), BatchNorm
     statistics or u within 1e-5 of max(1, |ref|) (a running mean also
     of its running variance's square root), logs within 1e-5
     (MULTI_TOL; stage 1's grad_norm within 1e-4); the GAN's gradients by phase 17's GAN_CHECK_TOL (2e-4 /
     1e-5 of the generator's / discriminators' largest element); exact
     launches a rank; the TP2 state's
     s1_ file (rank 0, single-card layout) read into a one-card state; step
     p50s, the gradient all-reduce's ms an update and peak memory a rank,
     labelled one card shared. Then serving on two replicas of cuda:0, bf16
     B4 x 240 ragged and f32 B1 x 96 (a pad row): PCM16 within 1 step of
     the plain call, p50 beside it. Prints one "multi_gpu" JSON line.
 22. AV-HuBERT masked-prediction pretraining (models/avhubert_pretrain.py)
     at full width (dim 1024, 24 layers, 500 classes, audio and video,
     modality dropout 0.5, dropout 0), f32 with TF32 off, random weights
     from seed 0, B4 x 250 ragged: one step's logits, loss and gradients on
     the attention kernel against the same step on the plain attention
     (logits within 1e-4 of max |ref|, the loss within 1e-4 relative,
     gradients within ten times an ulp twin's error), which the kernel 0.1%
     off must fail; three Adam steps with
     exactly 24 attention launches a forward and a step, p50, peak memory,
     a profiled step (busy ms, the kernel's share), a step inside
     utils.profiling.device_trace holding its annotate ranges and the
     kernel; the card against the CPU at B1 x 50; the optional modules
     (Conv1dResNetFrontend, ShuffleNet3DFrontend, VQQuantizer, three
     VQBottleneck EMA updates) against the CPU. Prints one "pretrain" JSON
     line and the phase's seconds.
 23. the dataset tools and the capacity probe at the full width of
     multi_target, through their entry points, in a temporary directory:
     create_dataset init (4 raw 240 x 320 clips of 40-64 frames with
     landmarks, a random GE2E encoder, --workers 2) on the card against
     --device cpu (crops, wavs and label files equal; mels and d-vectors
     within 1e-4 of max |ref|); train_stage1, one update of batch 2 on
     that tree (12 rel_attention and 12 rel_attention_bwd launches); infer
     from the update's file against the CPU (CLI_REL_TOL, units only at
     near-ties); create_dataset vocoder on both; vocode (a random
     generator, 4 trio launches an utterance); overlay
     --denoise-and-normalise over its wavs on the card against the CPU
     (1e-4 of max |ref|), the mux backend and count printed;
     find_max_duration to its 24 s cap in 4 s steps, f32 with TF32 off:
     every probe ok, exactly 12 rel_attention and 4 trio launches a
     forward (two forwards a probe), each probe's latency and real-time
     factor beside the card's name and power limit, the 8 s probe's
     waveform against the same weights' plain path on the CPU (1e-3), and
     a forward raising an error other than out of memory fails the tool
     (an injected out of memory ends the list). Prints the phase's JSON.
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
import re
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


# libraries that run their products on wgmma (HGMMA; f32 in 3xTF32): the
# three forwards (flash_fwd_hopper.cuh) and the trio every product, the two
# key-major backwards with their f32 products that reduce over queries or
# keys still on mma.sync (HMMA, unchecked; each source note says why)
HGMMA_KERNELS = ("rel_attention", "attention", "rel_attention_bias", "rel_attention_bwd",
                 "rel_attention_bias_bwd", "fused_tail")
# libraries that must have no HMMA
WGMMA_ONLY = ("fused_tail", "rel_attention_bias")
# libraries that must have no generic load or store (every shared pointer
# derived from the dynamic shared array by offsets)
NO_GENERIC = ("fused_tail", "rel_attention_bias", "rel_attention_bias_bwd")


def sass_tensor_core_counts(build) -> dict:
    """Tensor-core instructions in each kernel library's SASS (cuobjdump):
    {"hmma", "hmma_tf32", "hgmma", "hgmma_tf32"} -> {library: count}, HMMA
    (warp-level, mma.sync) and HGMMA (warpgroup, wgmma) apart, each with its
    TF32 ones apart, and "generic": its generic loads and stores (LD.E,
    ST.E; a shared access compiles to one where its pointer lost the shared
    space). Fails if a library of HGMMA_KERNELS has no HGMMA or no TF32
    HGMMA, one of WGMMA_ONLY any HMMA, or one of NO_GENERIC any generic
    access."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    counts = {"hmma": {}, "hmma_tf32": {}, "hgmma": {}, "hgmma_tf32": {}, "generic": {}}
    for lib in sorted(build._build_dir().glob("lib*.so")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        name = lib.stem[3:]
        for kind, word in (("hmma", "HMMA"), ("hgmma", "HGMMA")):
            found = [line for line in sass.splitlines() if word in line]
            counts[kind][name] = len(found)
            counts[f"{kind}_tf32"][name] = sum(1 for line in found if "TF32" in line)
        counts["generic"][name] = len(re.findall(r"\b(?:LD|ST)\.E\b", sass))
    print(f"SASS HMMA instructions per library: {counts['hmma']}; of them TF32: "
          f"{counts['hmma_tf32']}", flush=True)
    print(f"SASS HGMMA instructions per library: {counts['hgmma']}; of them TF32: "
          f"{counts['hgmma_tf32']}", flush=True)
    print(f"SASS generic loads and stores (LD.E / ST.E) per library: {counts['generic']}",
          flush=True)
    missing = [f"{k} ({kind})" for kind in ("hgmma", "hgmma_tf32") for k in HGMMA_KERNELS
               if not counts[kind].get(k)]
    if missing:
        fail(f"no tensor-core instruction of the expected kind in {missing}")
    stray = [f"{k} ({kind} {counts[kind][k]})" for kind, libs in (("hmma", WGMMA_ONLY),
                                                                 ("generic", NO_GENERIC))
             for k in libs if counts[kind].get(k)]
    if stray:
        fail(f"HMMA or generic loads and stores in {stray}")
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
    frames of a full extraction chunk). bf16 times at B4 H16 T240, B8 H16
    T600 and B1 H12 T4999; the f32 path (3xTF32) within ATTENTION_F32_TOL of the plain
    version in every f32 case, where attention_one_tf32 must not be (read
    over the same rows), and timed at B1 H16 T96, B4 H16 T240, B1 H12 T500
    and B1 H12 T4999 beside f32 SDPA, the plain version, its f32 FMA bound
    and its 3xTF32 bound."""
    set_tf32(False)
    gen = torch.Generator().manual_seed(3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dk = 64
    bf16, f32, failures, bf16_err = {}, {}, [], 0.0
    cases = [(4, 16, 240, "ragged", torch.bfloat16, True), (4, 16, 240, "ragged", torch.float32, True),
             (4, 16, 235, "ragged", torch.bfloat16, False), (4, 16, 235, "ragged", torch.float32, False),
             (4, 16, 235, "empty row", torch.bfloat16, False),
             (4, 16, 235, "empty row", torch.float32, False),
             (8, 16, 600, "ragged", torch.bfloat16, True), (8, 16, 600, "ragged", torch.float32, False),
             (1, 16, 96, "ragged", torch.float32, True),        # the flagship's f32 request
             (1, 12, 1499, "no mask", torch.bfloat16, False),
             (1, 12, 1499, "no mask", torch.float32, False),
             (1, 12, 4999, "no mask", torch.bfloat16, True),    # one 1.6 M-sample chunk
             (1, 12, 4999, "no mask", torch.float32, True),
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
            else:
                bf16[f"B{b}H{h}T{t}"] = numbers
        if not is_f32:
            bf16_err = max(bf16_err, err)
        print(line, flush=True)
        if not ok:
            failures.append(line)
        del q, k, v
        torch.cuda.empty_cache()
    if failures:
        fail(f"attention kernel disagrees with its plain version, or 1xTF32 passes the f32 "
             f"limit: {failures}")
    # the serving shape's bf16 reading heads the kernels line; every timed
    # reading stands under its shape
    return {"max_abs_err": bf16_err, **bf16["B4H16T240"], "bf16": bf16, "f32": f32}


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


def profile_call(fn, what: str, top: int = 12, by_name: dict | None = None,
                 stats: dict | None = None, host_ops: bool = True) -> float:
    """Device time by kernel over one call of fn, and the device's busy share
    of the call's wall time (torch.profiler, CUPTI). Returns the device's
    busy milliseconds; by_name, when given, gets each kernel's ms by name,
    stats the profiled wall ms and the number of device launches. Without
    host_ops only the device is traced (a call of ~10^4 launches is
    summarised in seconds, not minutes)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA], acc_events=True) as prof:
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
    if stats is not None:
        stats.update(wall_ms=wall_ms, launches=sum(e.count for e in rows))
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
        att_ms = sum(ms for k, ms in by_name.items() if "attention_wgmma" in k and "rel_" not in k)
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


def sdpa_bwd_ms(q, k, v, bias, g, bias_grad: bool = False) -> float:
    """The backward of one scaled_dot_product_attention call with the
    position bias as a float mask (the library yardstick); with bias_grad
    the bias requires grad too, so the library also computes dbias, which
    the shear route's dq_v and dp need."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    bias = bias.detach().requires_grad_(bias_grad)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    wrt = (q, k, v, bias) if bias_grad else (q, k, v)
    return time_ms(lambda: torch.autograd.grad(out, wrt, g, retain_graph=True), iters=5)


def shear_bwd_times(ra, gen, dev, b, h, t, dtype=torch.bfloat16) -> dict:
    """Kernel 3 (all keys valid) beside its bound, its plain version and the
    backward of SDPA with the position term as a float bias mask, the bias
    requiring grad (library_ms: dbias is what dq_v and dp need) and not
    (library_ms_bias_no_grad); in f32 (3xTF32) the f32 FMA bound and the
    3xTF32 bound."""
    dk, sz = 64, torch.finfo(dtype).bits // 8
    (q_u, q_v, k, v, p), _, g = bwd_inputs(gen, b, h, t, dtype, dev)
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    out, lse = ra.rel_attention_kernel(q_u, q_v, k, v, p, mask)
    k_ms = time_ms(lambda: ra.rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g),
                   iters=5 if dtype == torch.float32 and t >= TRAIN_SHAPE[2] else 10)
    plain_ms = time_ms(lambda: ra.rel_attention_bwd_plain(q_u, q_v, k, v, p, mask, lse, out, g), iters=3)
    bias = ra.rel_position_bias(q_v, p).to(dtype)
    lib_ms = sdpa_bwd_ms(q_u, k, v, bias, g, bias_grad=True)
    lib_no_grad_ms = sdpa_bwd_ms(q_u, k, v, bias, g)
    del bias
    # inputs q_u q_v k v out dO and p, mask, lse once; outputs dq_u dq_v dk dv and dp once
    n_bytes = 10 * b * h * t * dk * sz + 2 * h * (2 * t - 1) * dk * sz + b * t + b * h * t * 4
    flops = 8 * 2 * b * h * t * t * dk
    bms, by = bound_ms(n_bytes, flops, dtype)
    res = {"ms": k_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "library_ms_bias_no_grad": lib_no_grad_ms}
    line = (f"rel_attention_bwd B{b} H{h} T{t} {str(dtype)[6:]}: kernel_ms {k_ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA backward, float bias mask requiring "
            f"grad) library_ms_bias_no_grad {lib_no_grad_ms:.4f} (the same, the bias without "
            f"grad: no dbias) bound_ms {bms:.4f} ({by})")
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
    the 3xTF32 bound, the kernel in 3xTF32), its plain version, the backward
    of SDPA with the same bias as a float mask, the bias requiring grad
    (library_ms: the kernel returns dbias too) and not
    (library_ms_bias_no_grad), and the autograd of the bias construction
    that follows it in the route."""
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
    lib_ms = sdpa_bwd_ms(q_u, k, v, bias.to(dtype), g, bias_grad=True)
    lib_no_grad_ms = sdpa_bwd_ms(q_u, k, v, bias.to(dtype), g)
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
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA backward, the same bias requiring grad) "
          f"library_ms_bias_no_grad {lib_no_grad_ms:.4f} (the same, no dbias) bound_ms "
          f"{bounds['bound_ms']:.4f} ({bounds['bound_by']}; bytes {bounds['bytes_bound_ms']:.4f}, "
          f"operations {bounds['operations_bound_ms']:.4f}){tf32x3}; autograd of rel_position_bias "
          f"{bias_bwd_ms:.4f} ms: bias route backward {k_ms + bias_bwd_ms:.4f} ms | shear route "
          f"backward {shear_ms:.4f} ms", flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_ms_bias_no_grad": lib_no_grad_ms, **bounds, "bias_autograd_ms": bias_bwd_ms}


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
                           tol: float = 1e-3, split: str = "all") -> tuple[int, int]:
    """Units of the card's run against the CPU's, utterance by utterance:
    where they differ, the card's unit must be within `tol` (f32_check's
    limit on logits) of the CPU's top logit at that position. Returns
    (positions compared, positions that differ); fails otherwise."""
    from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
    from lip2speech_tpu_torch.models.multi_target import MultiTargetModel

    ds = Stage1Dataset(label / f"{split}.tsv", label / f"{split}.unt", train=False)
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


# phase 20: lip-reading recognition
ASR_LENS = (96, 80, 64, 50)      # frames of the ragged batch-4 request
ASR_BEAM, ASR_MAX_LEN = 10, 50
ASR_ENC_TOL = 1e-4               # encoder states, card against CPU, of max |ref| (valid frames)
ASR_SCORE_TOL = 1e-4             # teacher-forced n-best scores, card against CPU, of max(1, |ref|)
ASR_DECODER_LAYERS = 2           # of the CLI's 6: a depth cut that keeps the whole run under 570 s


def asr_request(b: int, lens, seed: int, frames: int = 96):
    rng = np.random.default_rng(seed)
    video = torch.from_numpy(rng.standard_normal((b, frames, 88, 88, 1)).astype(np.float32))
    return video, torch.from_numpy(np.arange(frames)[None, :] < np.asarray(lens)[:, None])


def asr_models(cfgs) -> dict:
    """name -> (CPU model, card model) with the same random weights, in eval
    mode. cfgs: name -> (seed, constructor)."""
    from lip2speech_tpu_torch.models.layers import init_weights

    out = {}
    for name, (seed, build) in cfgs.items():
        cpu = build()
        init_weights(cpu, torch.Generator().manual_seed(seed))
        cpu.eval().requires_grad_(False)
        gpu = build()
        gpu.load_state_dict(cpu.state_dict())
        out[name] = (cpu, gpu.cuda().eval().requires_grad_(False))
    return out


def first_nbest_difference(got, ref) -> str:
    for i, (g_rows, r_rows) in enumerate(zip(got, ref)):
        for k, (g, r) in enumerate(zip(g_rows, r_rows)):
            if g != r:
                step = next((s for s, (a, b) in enumerate(zip(g, r)) if a != b),
                            min(len(g), len(r)))
                return f"row {i} hypothesis {k} from step {step}"
    return "none"


def phase_asr(counters: dict) -> dict:
    """The recognition path at the CLI's full width (random weights, f32,
    TF32 off, beam 10, 50 steps; the decoders cut to ASR_DECODER_LAYERS of
    the CLI's 6): AV-HuBERT seq2seq (encoder 1024 x 24, 16 heads, FFN 4096;
    decoder 1024 x 3, 4 heads, FFN 3072; char vocabulary)
    at B1 x 96 and B4 ragged, alone and with a 6-layer LM (512 / 8 / 2048)
    at 0.3; RAVEn (1024 x 24, 16 heads, decoder 1024 x 3) with the joint
    CTC/attention search
    at CTC weight 0.1 at both shapes. Each decode: exact launches (attention
    24, or rel_attention 24, others 0), the encoder states against the same
    weights' CPU run, the card's n-best teacher-forced on the CPU, p50 of 5
    calls, one profiled call (busy ms, launches); at B1 whether the n-best
    equals the CPU search's. Then infer_asr in both modes on 4 clips, its
    hypo.json against the direct decode of the same batch on the card.
    Returns {kernel: {decode: launches}}."""
    from lip2speech_tpu_torch.cli import infer_asr
    from lip2speech_tpu_torch.data.manifest import Utterance, write_manifest
    from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
    from lip2speech_tpu_torch.data.text import SentenceProcessor
    from lip2speech_tpu_torch.data.video_io import save_video_gray
    from lip2speech_tpu_torch.models.avhubert_asr import AVHubertSeq2Seq, Seq2SeqConfig
    from lip2speech_tpu_torch.models.lm import TransformerLM
    from lip2speech_tpu_torch.models.raven_asr import RavenASR

    set_tf32(False)
    t_phase = time.perf_counter()
    processor = SentenceProcessor()
    nc = processor.num_classes
    av_cfg = Seq2SeqConfig(vocab_size=nc, encoder_dim=1024, encoder_heads=16, encoder_ffn_dim=4096,
                           encoder_layers=24, decoder_dim=1024, decoder_heads=4,
                           decoder_ffn_dim=3072, decoder_layers=ASR_DECODER_LAYERS)
    raven_cfg = RavenASR.from_num_classes(nc, dim=1024, heads=16, ffn_dim=4096, layers=24,
                                          decoder_layers=ASR_DECODER_LAYERS, decoder_heads=4)
    # seed 0 for both ASR models: infer_asr's random weights
    models = asr_models({"avhubert": (0, lambda: AVHubertSeq2Seq(av_cfg)),
                         "lm": (1, lambda: TransformerLM(nc, 512, 8, 2048, 6)),
                         "raven": (0, lambda: RavenASR(raven_cfg))})
    print(f"asr: models built in {time.perf_counter() - t_phase:.1f} s; parameters "
          + ", ".join(f"{k} {sum(p.numel() for p in m[0].parameters()) / 1e6:.1f} M"
                      for k, m in models.items()), flush=True)
    requests = {"B1x96": asr_request(1, (96,), seed=20),
                "B4x96 ragged": asr_request(4, ASR_LENS, seed=21)}
    decodes = [(f"{model} {shape}{' +LM' if lm else ''}", model, shape, lm)
               for model, lm in (("avhubert", False), ("avhubert", True), ("raven", False))
               for shape in requests]
    kernel_of = {"avhubert": "attention", "raven": "rel_attention"}
    read, launches, encoded = {}, {name: {} for name in counters}, {}
    with torch.inference_mode():
        for what, name, shape, with_lm in decodes:
            cpu, gpu = models[name]
            video, mask = requests[shape]
            gv, gm = video.cuda(), mask.cuda()
            lm_kw = {"lm": models["lm"][1], "lm_weight": 0.3} if with_lm else {}
            if name == "avhubert":
                kw = dict(max_len=ASR_MAX_LEN)
                decode = lambda: gpu.decode_beam(gv, gm, beam=ASR_BEAM, **kw, **lm_kw)  # noqa: E731
            else:
                kw = dict(max_len=ASR_MAX_LEN, ctc_weight=0.1)
                decode = lambda: gpu.decode_joint(gv, gm, beam=ASR_BEAM, **kw)  # noqa: E731
            decode()                                              # warm-up
            (nbest, scores), _, _, _ = run_counted(counters, decode, {kernel_of[name]: 24}, what)
            for k in counters:
                launches[k][what] = counters[k].launches
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                decode()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            stats: dict = {}
            t = time.perf_counter()
            busy = profile_call(decode, what, top=6, stats=stats, host_ops=False)
            profile_s = time.perf_counter() - t
            # the CPU run of the same weights: encoder states, then the card's
            # n-best teacher-forced
            if (name, shape) not in encoded:
                t = time.perf_counter()
                encoded[(name, shape)] = (cpu.encode(video, mask) if name == "avhubert"
                                          else cpu.encoder(video, mask))
                print(f"{what}: CPU encoder {time.perf_counter() - t:.1f} s", flush=True)
            ref = encoded[(name, shape)]
            got = gpu.encode(gv, gm) if name == "avhubert" else gpu.encoder(gv, gm)
            ref_states, got_states = (ref, got) if name == "avhubert" else (ref[0], got[0])
            valid = mask[:, :, None]
            enc_err = float(((got_states.cpu() - ref_states).abs() * valid).max()
                            / (ref_states.abs() * valid).max())
            cpu_lm = {"lm": models["lm"][0], "lm_weight": 0.3} if with_lm else {}
            t = time.perf_counter()
            if name == "avhubert":
                _, forced = cpu.rescore(video, mask, nbest, enc=ref, **kw, **cpu_lm)
            else:
                _, forced = cpu.rescore_joint(video, mask, nbest, encoded=ref, **kw)
            forced = forced.numpy()
            score_err = float((np.abs(forced - scores) / np.maximum(1.0, np.abs(forced))).max())
            rescore_s = time.perf_counter() - t
            same = "not run at batch 4 (the CPU search of 40 hypotheses x 50 steps)"
            cpu_s = None
            if shape == "B1x96":
                t = time.perf_counter()
                cpu_nbest, _ = (cpu.decode_beam(video, mask, beam=ASR_BEAM, **kw, **cpu_lm)
                                if name == "avhubert"
                                else cpu.decode_joint(video, mask, beam=ASR_BEAM, **kw))
                cpu_s = time.perf_counter() - t
                same = ("equal" if cpu_nbest == nbest
                        else f"differs: {first_nbest_difference(nbest, cpu_nbest)}")
            p50 = float(np.median(times))
            read[what] = {"p50_ms": p50, "min_ms": min(times), "max_ms": max(times),
                          "busy_ms": busy, "busy_share": busy / stats["wall_ms"],
                          "launches_a_decode": stats["launches"], "encoder_err": enc_err,
                          "score_err": score_err, "nbest_vs_cpu": same, "cpu_search_s": cpu_s,
                          kernel_of[name]: launches[kernel_of[name]][what],
                          "best": processor.decode(
                              [t for t in (nbest[0][0] if name == "avhubert"
                                           else gpu.to_text_ids(nbest[0][0])) if t < nc])}
            print(f"{what}: p50_ms {p50:.3f} (5 calls, min {min(times):.3f} max {max(times):.3f}); "
                  f"device_busy_ms {busy:.3f} busy_share {busy / stats['wall_ms']:.3f} "
                  f"launches {stats['launches']}; encoder max_err/max|ref| {enc_err:.2e} "
                  f"(tol {ASR_ENC_TOL}); teacher-forced scores on the CPU max_err {score_err:.2e} "
                  f"of max(1, |ref|) (tol {ASR_SCORE_TOL}, {rescore_s:.1f} s); n-best vs the CPU "
                  f"search: {same}" + (f" ({cpu_s:.1f} s)" if cpu_s else "")
                  + f"; profiling {profile_s:.1f} s", flush=True)
            if not np.isfinite(scores).all() or scores.shape != (video.shape[0], ASR_BEAM):
                fail(f"{what}: bad scores {scores}")
            if enc_err > ASR_ENC_TOL:
                fail(f"{what}: encoder states off the CPU's by {enc_err:.2e} of max |ref|")
            if score_err > ASR_SCORE_TOL:
                fail(f"{what}: teacher-forced scores off the card's by {score_err:.2e}")
        # the CLI in both modes on 4 clips (one 96-frame bucket, one batch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_asr_") as tmp:
            root = Path(tmp)
            rng = np.random.default_rng(22)
            utts, refs = [], {}
            for i, n in enumerate(ASR_LENS):
                uid = f"spk0/clip{i}"
                save_video_gray(root / "video" / f"{uid}.mp4",
                                rng.integers(0, 256, (n, 96, 96), dtype=np.uint8))
                (root / "spk_emb" / "spk0").mkdir(parents=True, exist_ok=True)
                np.save(root / "spk_emb" / f"{uid}.npy", np.zeros(256, np.float32))
                utts.append(Utterance(uid, root / "video" / f"{uid}.mp4",
                                      root / "audio" / f"{uid}.wav", n, n * 640))
                refs[uid] = ["bin blue at f two now", "place red", "lay green", "set it"][i]
            write_manifest(root / "test.tsv", root, utts)
            (root / "refs.json").write_text(json.dumps(refs))
            (batch,) = Stage1Dataset(root / "test.tsv").batches(4)
            gv, gm = (torch.as_tensor(batch[k], device="cuda") for k in ("video", "frames_mask"))
            for mode, flags in (("avhubert", []), ("raven", ["--raven", "--ctc-weight", "0.1"])):
                what = f"infer_asr {mode} (4 clips, batch 4)"
                args = ["--tsv", str(root / "test.tsv"), "--transcripts", str(root / "refs.json"),
                        "--out-dir", str(root / mode), "--batch-size", "4",
                        "--decoder-layers", str(ASR_DECODER_LAYERS), *flags]
                _, seconds, _, _ = run_counted(counters, lambda: infer_asr.main(args),
                                                 {kernel_of[mode]: 24}, what)
                for k in counters:
                    launches[k][what] = counters[k].launches
                gpu = models[mode][1]
                if mode == "avhubert":
                    nbest, scores = gpu.decode_beam(gv, gm, beam=ASR_BEAM, max_len=ASR_MAX_LEN)
                else:
                    nbest, scores = gpu.decode_joint(gv, gm, beam=ASR_BEAM, max_len=ASR_MAX_LEN,
                                                     ctc_weight=0.1, len_penalty=1.0)
                hypos = json.loads((root / mode / "hypo.json").read_text())
                wer = (root / mode / "wer.txt").read_text().splitlines()[0]
                direct, err = {}, 0.0
                for i, uid in enumerate(batch["ids"]):
                    hyp = nbest[i][0] if mode == "avhubert" else gpu.to_text_ids(nbest[i][0])
                    direct[uid] = processor.decode([t for t in hyp if t < nc])
                    ref = float(scores[i, 0])
                    err = max(err, abs(hypos[uid]["score"] - ref) / max(1.0, abs(ref)))
                same = {u: h["hypo"] for u, h in hypos.items()} == direct
                print(f"{what}: {seconds:.1f} s with the model's random init; {wer}; hypo.json "
                      f"texts {'equal' if same else 'DIFFER'} to the direct decode on the card, "
                      f"scores within {err:.2e}", flush=True)
                read[what] = {"seconds": seconds, "wer_line": wer, "score_err": err}
                if not same or err > ASR_SCORE_TOL:
                    fail(f"{what}: hypo.json differs from the direct decode of the same batch")
    read["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20 recognition: {read['seconds']:.1f} s", flush=True)
    print(json.dumps({"asr": read}), flush=True)
    del models
    torch.cuda.empty_cache()
    return launches


MULTI_TIMEOUT_S = 300.0        # seconds a collective of phase 21 may wait
MULTI_TOL = {"grads": 1e-4,    # stage 1: of the step's largest element, and in the 2-norm
                               # of the whole gradient's (phase 13's pair)
             "stats": 1e-5,    # of max(1, each tensor's max |ref|): BatchNorm statistics, u
             "logs": 1e-5,     # relative
             # relative, stage 1's grad_norm: rounding alone moves the flagship step's
             # (1 x 240) by up to 4.2e-5, the plain attention versions against their ulp
             # twins at weight seeds 0-3 (PERF.md)
             "grad_norm": 1e-4}
MULTI_SHAPES = {"multi_target": (2, 4, 600), "multi_target_avhubert": (1, 1, 240)}  # accum, B, T
MULTI_SERVING = ((torch.bfloat16, 4, 240, MAIN_LENS), (None, 1, 96, (96,)))   # dtype, B, T, lens


def kernel_counters() -> dict:
    """Kernel name -> the wrapper whose .launches counts its launches."""
    from lip2speech_tpu_torch.ops import attention as att
    from lip2speech_tpu_torch.ops import fused_tail as ft
    from lip2speech_tpu_torch.ops import rel_attention as ra

    return {"rel_attention": ra.rel_attention_kernel,
            "rel_attention_bwd": ra.rel_attention_bwd_kernel,
            "rel_attention_bias": ra.rel_attention_bias_kernel,
            "rel_attention_bias_bwd": ra.rel_attention_bias_bwd_kernel,
            "attention": att.attention_kernel,
            "fused_resblock_trio": ft.fused_resblock_trio_kernel}


def multi_cfg(preset, name: str):
    """Phase 21's stage-1 configuration of a preset: f32 (bf16_compute off,
    as train_stage1 runs it), dropout 0, the first update at rate 0 (so
    Adam's first moment is (1 - b1) x the gradient), the accumulation of
    MULTI_SHAPES."""
    base = preset(name)
    conf = dataclasses.replace(base.model.conformer, dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, conformer=conf, final_dropout=0.0),
        stage1=dataclasses.replace(base.stage1, warmup_updates=2, max_updates=10,
                                   update_freq=MULTI_SHAPES[name][0], bf16_compute=False))


def multi_expected(cfg, name: str) -> dict:
    accum = MULTI_SHAPES[name][0]
    layers = cfg.model.conformer.layers
    out = {"rel_attention": layers * accum, "rel_attention_bwd": layers * accum}
    if name == "multi_target_avhubert":
        out["attention"] = cfg.model.frontend.encoder_layers * accum
    return out


def stage1_reading(state, logs: dict) -> dict:
    """The update's gradients by name (Adam's first moments over 1 - b1,
    after the first update), in the single-card layout (every rank of a
    mesh gathers), the BatchNorm statistics and the logs; on the CPU."""
    from lip2speech_tpu_torch.train import checkpoint

    content = checkpoint.stage1_content(state)
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    b1 = state.optimizer.param_groups[0]["betas"][0]
    grads = {names[i]: (s["exp_avg"] / (1 - b1)).cpu()
             for i, s in content["optimizer"]["state"].items()}
    stats = {k: v.cpu().clone() for k, v in content["model"].items() if "running" in k}
    return {"grads": grads, "stats": stats, "logs": logs}


def gan_reading(state, logs: dict) -> dict:
    """The first GAN step's gradients by name (first moments over 1 - b1),
    the spectral u and the logs; on the CPU."""
    grads = {}
    for opt, mods in ((state.gen_opt, {"generator": state.generator}),
                      (state.disc_opt, {"mpd": state.mpd, "msd": state.msd})):
        b1 = opt.param_groups[0]["betas"][0]
        for pre, m in mods.items():
            grads.update({f"{pre}.{n}": (opt.state[p]["exp_avg"] / (1 - b1)).cpu()
                          for n, p in m.named_parameters()})
    return {"grads": grads, "stats": {k: v.cpu().clone() for k, v in state.msd.named_buffers()},
            "logs": logs}


def multi_errors(got: dict, ref: dict, what: str, gan: bool = False) -> dict:
    """The worst error of each kind against the single-process reference,
    each over its scale and as a share of its limit (fails over 1):
    - stage 1's gradients, as phase 13 holds the card to the CPU: each
      tensor's largest error over the step's largest gradient element, and
      its error's 2-norm over the whole gradient's 2-norm (grad_shares),
      limit MULTI_TOL["grads"], or ten times the worst the reference's ulp
      twin reads if more (phase 13's rule). Per tensor over its own max |ref| would
      not do: the model is piecewise linear, and a ReLU input within
      rounding of 0 gates one way on one side and the other way on the
      other (the ranks' other batch sizes take other cuBLAS and cuDNN
      algorithms), so one position's share moves in the weights behind it;
      a gradient that is zero in exact arithmetic (the bias in front of a
      BatchNorm) is noise on both sides; and the frontend's conv weight
      gradients sum ~10^7 products in f32 in an order the batch size picks;
    - the GAN's: over its side's largest element (generator, or the
      discriminators), limits GAN_CHECK_TOL as phase 17's;
    - statistics (running mean and variance, u): over max(1, the tensor's
      max |ref|), a running mean's also over the square root of its layer's
      running variance if more (a batch mean rounds at the size of the
      values it sums), limit MULTI_TOL["stats"];
    - logs: relative, limit MULTI_TOL["logs"], stage 1's grad_norm
      MULTI_TOL["grad_norm"] (the norm of gradients whose rounding the
      gradients' own limit allows for)."""
    grads = ref["grads"]
    side = (lambda k: "disc" if k.startswith(("mpd.", "msd.")) else "generator") if gan else (
        lambda k: "step")
    top: dict = {}
    for k, g in grads.items():
        top[side(k)] = max(top.get(side(k), 0.0), float(g.abs().max()))
    stage1 = {} if gan else grad_shares(got["grads"], grads)
    worst = {}
    for kind in ("grads", "stats", "logs"):
        if set(got[kind]) != set(ref[kind]):
            fail(f"{what}: {kind} by name differ: {sorted(set(got[kind]) ^ set(ref[kind]))[:5]}")
        share = {}
        for k, r in ref[kind].items():
            if kind == "logs":
                limit = MULTI_TOL["grad_norm" if k == "grad_norm" and not gan else "logs"]
                share[k] = abs(got[kind][k] - r) / max(abs(r), 1e-30) / limit
                continue
            diff = got[kind][k] - r
            if kind == "grads" and gan:
                share[k] = float(diff.abs().max()) / top[side(k)] / GAN_CHECK_TOL[side(k)]
            elif kind == "grads":
                # within the limit, or within ten times what rounding alone moves the
                # gradient anywhere (phase 13's rule: a gate flips where rounding puts it)
                share[k] = stage1[k] / max(1.0, 10 * max(ref["ulp_twin"].values()))
            else:
                var = ref[kind].get(k.replace("running_mean", "running_var"))
                scale = max(float(r.abs().max()), 1.0, math.sqrt(float(var.max())) if k.endswith(
                    "running_mean") and var is not None else 0.0)
                share[k] = float(diff.abs().max()) / scale / MULTI_TOL["stats"]
        at = max(share, key=share.get)
        worst[kind] = {"share_of_limit": share[at], "at": at}
        if kind == "grads":
            for k in sorted(share, key=share.get)[-3:]:
                print(f"{what}: gradient {k}: {share[k]:.3f} of the limit ("
                      f"{stage1.get(k, share[k]):.3f} of MULTI_TOL); its max |ref| "
                      f"{float(grads[k].abs().max()) / top[side(k)]:.2e} of the largest", flush=True)
    print(f"{what}: against the single-process step, worst share of the limit {worst}", flush=True)
    if any(w["share_of_limit"] > 1.0 for w in worst.values()):
        fail(f"{what}: over the limit against the single-process step")
    return worst


def grad_shares(got: dict, ref: dict) -> dict:
    """Each stage-1 gradient's error as a share of MULTI_TOL["grads"]: the
    larger of its largest error over the step's largest element and its
    error's 2-norm over the whole gradient's 2-norm (phase 13's pair)."""
    top = max(float(g.abs().max()) for g in ref.values())
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in ref.values()))
    return {k: max(float((got[k] - r).abs().max()) / top,
                   float((got[k] - r).double().norm()) / norm) / MULTI_TOL["grads"]
            for k, r in ref.items()}


def ulp_twin(s1, cfg, counters, batch, expected, ref: dict, what: str) -> dict:
    """The yardstick of rounding (phase 13's twin): the single-card step
    from weights moved by about one unit in the last place (times 1 + 1e-7
    x normal noise), its gradients' shares of the limit against the
    reference's, by name."""
    state = s1.create_train_state(cfg, seed=0)
    noise = torch.Generator(device=state.device).manual_seed(7)
    with torch.no_grad():
        for p in s1.trained_parameters(state.model):
            p.mul_(1 + 1e-7 * torch.randn(p.shape, device=p.device, generator=noise))
    _, twin, _ = counted_steps(counters, s1.make_train_step(cfg), state, batch, expected,
                               f"{what} ulp twin", 1)
    shares = grad_shares(twin["grads"], ref["grads"])
    at = max(shares, key=shares.get)
    print(f"{what} ulp twin: its gradients against the step's, worst {shares[at]:.3f} of the "
          f"limit at {at}", flush=True)
    return shares


def counted_steps(counters, step, state, batch, expected, what, n: int, gan: bool = False):
    """n counted steps (exact launches each); returns (first logs, reading
    after the first, step ms)."""
    counted = counted_gan_step if gan else counted_step
    times, reading, logs = [], None, None
    for i in range(n):
        out = counted(counters, step, state, batch, expected, f"{what} step {i + 1}")
        times.append(out[1])
        if i == 0:
            logs = out[0]
            reading = gan_reading(state, logs) if gan else stage1_reading(state, logs)
    return logs, reading, times


def local_heads(model) -> dict:
    """Heads a rank holds of the first attention block of each kind."""
    heads = {}
    for m in model.modules():
        if hasattr(m, "tp_parts") and hasattr(m, "heads"):
            heads.setdefault(type(m).__name__, m.heads // (m.tp.size if m.tp else 1))
    return heads


def all_reduce_ms(params, mesh, calls: int = 3) -> float:
    """Milliseconds of one update's gradient all-reduce (all_reduce_flat of
    tensors shaped as the trained parameters over the data group)."""
    from lip2speech_tpu_torch.parallel.collectives import all_reduce_flat

    grads = [torch.zeros_like(p) for p in params]
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_reduce_flat(grads, mesh.data_group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def multi_rank(rank: int, world: int, tmp: str) -> None:
    """One of phase 21's two ranks on the one card (gloo over a FileStore in
    tmp, CUDA tensors): the DP2 stage-1 step (2 + 2 rows), DP1 x TP2 of the
    same step (4 heads a rank), a TP2 step of the flagship (its AV-HuBERT
    encoder 8 heads a rank) and the DP2 GAN step (8 + 8 rows), each with
    exact launches, against the single-process references the parent left
    in tmp. Writes its readings to tmp/rank<r>.pt; rank 0 also writes the
    TP2 state as an s1_ file for the parent to read on one card."""
    sys.path.insert(0, str(REPO))
    from lip2speech_tpu_torch.core.config import preset
    from lip2speech_tpu_torch.parallel import multihost
    from lip2speech_tpu_torch.parallel.mesh import make_mesh
    from lip2speech_tpu_torch.train import checkpoint
    from lip2speech_tpu_torch.train import stage1 as s1
    from lip2speech_tpu_torch.train import stage2 as s2

    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    multihost.initialize(init_method=f"file://{tmp}/gloo", num_processes=world, process_id=rank,
                         backend="gloo", device=torch.device("cuda", 0), timeout=MULTI_TIMEOUT_S)
    counters = kernel_counters()
    ref = torch.load(Path(tmp) / "reference.pt", weights_only=False)
    read = {}
    for name, (data, model), preset_name, n in (
            ("dp2", (2, 1), "multi_target", 3), ("tp2", (1, 2), "multi_target", 2),
            ("flagship_tp2", (1, 2), "multi_target_avhubert", 1)):
        cfg = multi_cfg(preset, preset_name)
        accum, b, frames = MULTI_SHAPES[preset_name]
        mesh = make_mesh(data=data, model=model)
        torch.cuda.reset_peak_memory_stats()
        state = s1.create_train_state(cfg, seed=0, mesh=mesh)
        step = s1.make_train_step(cfg, mesh)
        what = (f"phase 21 rank {rank} {name} {preset_name} {b}x{frames}x{accum} f32 "
                f"(one card shared by two ranks)")
        _, got, times = counted_steps(counters, step, state, train_batch(cfg, accum, b, frames, 0),
                                      multi_expected(cfg, preset_name), what, n)
        read[name] = {"step_ms": times, "heads": local_heads(state.model),
                      "launches": multi_expected(cfg, preset_name),
                      "errors": multi_errors(got, ref[preset_name], what),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if name == "dp2":
            read[name]["all_reduce_ms"] = all_reduce_ms(s1.trained_parameters(state.model), mesh)
        if name == "tp2":
            checkpoint.save_stage1(tmp, state, state.step)
        del state, step
        torch.cuda.empty_cache()
    cfg = preset("multi_target")
    mesh = make_mesh(data=2)
    torch.cuda.reset_peak_memory_stats()
    state = s2.create_gan_state(cfg, seed=0, mesh=mesh)
    state.generator.code_dropout = 0.0
    step = s2.make_gan_step(cfg, mesh)
    what = (f"phase 21 rank {rank} GAN dp2 {cfg.stage2.batch_size}x{cfg.vocoder.segment_size} "
            f"f32 (one card shared)")
    _, got, times = counted_steps(counters, step, state,
                                  gan_batch(cfg, cfg.stage2.batch_size, seed=0),
                                  {"fused_resblock_trio": n_trio_stages(cfg.vocoder)}, what, 3,
                                  gan=True)
    read["gan_dp2"] = {"step_ms": times, "errors": multi_errors(got, ref["gan"], what, gan=True),
                       "launches": {"fused_resblock_trio": n_trio_stages(cfg.vocoder)},
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "all_reduce_ms": all_reduce_ms(list(state.generator.parameters()), mesh)}
    torch.save(read, Path(tmp) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def phase_multi_gpu(counters: dict, preset) -> dict:
    """Phase 21: the parallel layer on the one card, f32, TF32 off
    everywhere and cuDNN's deterministic algorithms (the comparisons hold
    the same f32 paths on both sides: with cuDNN free to choose, the
    single-card step repeated on the card differed from itself by up to
    1.1e-4 of a conv weight gradient's max |ref|), random weights from
    seed 0, dropout 0.

    1. NCCL at world size 1, in this process: the data-parallel stage-1 step
       of multi_target at 4 x 600 x 2 against the single-card step on the
       same state and batch (equal_runs: bit for bit, or as a twin of the
       single-card step is), exact launches,
       p50 of 3 steps each; the same for the GAN step at 16 x 8,960 (the
       generator's dropout off); a one-device serving mesh against the
       plain call (PCM16 equal). The single-card first steps, and one of the
       flagship at 1 x 240, are the references of 2.
    2. Two ranks sharing the card over gloo (multi_rank): DP2, DP1 x TP2,
       the flagship's TP2 and the GAN's DP2, each within MULTI_TOL of its
       reference, exact launches a rank; the TP2 state's s1_ file, written
       by rank 0 in the single-card layout, read into a one-card state.
    3. Serving on a mesh of two replicas of cuda:0: bf16 at B4 x 240 ragged
       and f32 at B1 x 96 (a pad row), PCM16 within 1 step of the plain
       call, p50 beside it.
    Shared-card times are not scaling: two ranks take turns on one card."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from lip2speech_tpu_torch.parallel import multihost
    from lip2speech_tpu_torch.parallel.mesh import make_mesh
    from lip2speech_tpu_torch.pipeline import synthesise as syn
    from lip2speech_tpu_torch.train import checkpoint
    from lip2speech_tpu_torch.train import stage1 as s1
    from lip2speech_tpu_torch.train import stage2 as s2

    t_phase = time.perf_counter()
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    read: dict = {}
    reference: dict = {}
    with tempfile.TemporaryDirectory(prefix="l2s_phase21_") as tmp:
        multihost.initialize(init_method=f"file://{tmp}/nccl", num_processes=1, process_id=0,
                             device=torch.device("cuda", 0), timeout=MULTI_TIMEOUT_S)
        try:
            mesh = make_mesh(data=1)
            print(f"phase 21: NCCL at world size 1, backend {dist.get_backend()}, mesh "
                  f"{mesh.shape}", flush=True)
            cfg = multi_cfg(preset, "multi_target")
            accum, b, frames = MULTI_SHAPES["multi_target"]
            batch = train_batch(cfg, accum, b, frames, seed=0)
            expected = multi_expected(cfg, "multi_target")
            runs = {}
            for kind, m in (("plain", None), ("twin", None), ("nccl", mesh)):
                state = s1.create_train_state(cfg, seed=0, mesh=m)
                what = f"phase 21 {kind} multi_target {b}x{frames}x{accum} f32"
                logs, reading, times = counted_steps(counters, s1.make_train_step(cfg, m), state,
                                                     batch, expected, what, 1)
                runs[kind] = (state, reading, times)
            reference["multi_target"] = runs["plain"][1]
            reference["multi_target"]["ulp_twin"] = ulp_twin(
                s1, cfg, counters, batch, expected, runs["plain"][1],
                f"phase 21 plain multi_target {b}x{frames}x{accum} f32")
            read["nccl_stage1"] = equal_runs(runs, "stage 1")
            for kind, m in (("plain", None), ("nccl", mesh)):
                state, _, times = runs[kind]
                times += [counted_step(counters, s1.make_train_step(cfg, m), state, batch, expected,
                                       f"phase 21 {kind} multi_target step {i}")[1] for i in (2, 3)]
                read["nccl_stage1"][f"{kind}_p50_ms"] = float(np.median(times))
            del runs, state
            torch.cuda.empty_cache()
            gcfg = preset("multi_target")
            gbatch = gan_batch(gcfg, gcfg.stage2.batch_size, seed=0)
            trio = {"fused_resblock_trio": n_trio_stages(gcfg.vocoder)}
            runs = {}
            for kind, m, n in (("plain", None, 3), ("twin", None, 1), ("nccl", mesh, 3)):
                state = s2.create_gan_state(gcfg, seed=0, mesh=m)
                state.generator.code_dropout = 0.0
                _, reading, times = counted_steps(
                    counters, s2.make_gan_step(gcfg, m), state, gbatch, trio,
                    f"phase 21 {kind} GAN {gcfg.stage2.batch_size}x{gcfg.vocoder.segment_size} f32",
                    n, gan=True)
                runs[kind] = (state, reading, times)
            reference["gan"] = runs["plain"][1]
            read["nccl_gan"] = equal_runs(runs, "GAN", gan=True)
            for kind in ("plain", "nccl"):
                read["nccl_gan"][f"{kind}_p50_ms"] = float(np.median(runs[kind][2]))
            del runs, state
            torch.cuda.empty_cache()
            pipe = syn.Lip2SpeechPipeline.initialize_random(gcfg, emit_int16=True)
            req = request(gcfg, 1, 96, [96], seed=21)
            plain = pipe.synthesise_batch(*req)
            pipe.set_mesh(make_mesh(devices=["cuda:0"]))
            meshed = pipe.synthesise_batch(*req)
            pipe.set_mesh(None)
            diff = max(pcm_diff(a.wav, c.wav) for a, c in zip(plain, meshed))
            print(f"phase 21 serving on a one-device mesh f32 B1x96: PCM16 max difference {diff} "
                  f"from the plain call", flush=True)
            if diff != 0 or not all(np.array_equal(a.units, c.units) for a, c in zip(plain, meshed)):
                fail("phase 21: a one-device serving mesh differs from the plain call")
            del pipe
        finally:
            dist.destroy_process_group()
        fcfg = multi_cfg(preset, "multi_target_avhubert")
        accum, b, frames = MULTI_SHAPES["multi_target_avhubert"]
        state = s1.create_train_state(fcfg, seed=0)
        fbatch, fexpected = train_batch(fcfg, accum, b, frames, 0), multi_expected(
            fcfg, "multi_target_avhubert")
        what = f"phase 21 plain multi_target_avhubert {b}x{frames}x{accum} f32"
        _, flagship, _ = counted_steps(counters, s1.make_train_step(fcfg), state, fbatch,
                                       fexpected, what, 1)
        del state
        flagship["ulp_twin"] = ulp_twin(s1, fcfg, counters, fbatch, fexpected, flagship, what)
        reference["multi_target_avhubert"] = flagship
        torch.cuda.empty_cache()
        torch.save(reference, Path(tmp) / "reference.pt")
        t_ranks = time.perf_counter()
        mp.start_processes(multi_rank, args=(2, tmp), nprocs=2, join=True, start_method="spawn")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
        print(f"phase 21: two ranks on one card over gloo took {time.perf_counter() - t_ranks:.1f} s "
              f"(processes, init, four runs)", flush=True)
        one_card, update = checkpoint.restore_stage1(tmp, s1.create_train_state(cfg, seed=0))
        tp2_steps = len(ranks[0]["tp2"]["step_ms"])
        print(f"phase 21: rank 0's TP2 s1_ file restored into a one-card state as --resume "
              f"does, at update {update}", flush=True)
        if not update == one_card.step == tp2_steps:
            fail("phase 21: the TP2 checkpoint did not restore on one card")
        del one_card
    for name in ranks[0]:
        read[name] = {f"rank{r}": ranks[r][name] for r in range(2)}
        for r in range(2):
            x = ranks[r][name]
            print(f"phase 21 {name} rank {r} (one card shared by two ranks): step_ms "
                  f"{[round(t, 1) for t in x['step_ms']]} p50 {float(np.median(x['step_ms'])):.1f}; "
                  f"peak memory {x['peak_gib']:.2f} GiB"
                  + (f"; gradient all-reduce {x['all_reduce_ms']:.1f} ms an update (gloo)"
                     if "all_reduce_ms" in x else "")
                  + (f"; heads a rank {x['heads']}" if "heads" in x else ""), flush=True)
    read["serving"] = multi_serving(syn, preset, make_mesh)
    torch.backends.cudnn.deterministic = False
    read["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21 multi-GPU on one card: {read['seconds']:.1f} s", flush=True)
    print(json.dumps({"multi_gpu": read}, default=float), flush=True)
    return read


def equal_runs(runs: dict, what: str, gan: bool = False) -> dict:
    """The NCCL world-size-1 run against the single-card one after the
    first step: bit for bit. The single-card step is run twice ("twin"):
    where the card does not repeat it bit for bit itself (cuDNN's and
    cuBLAS's f32 algorithms may sum with atomics), the NCCL run is held
    instead to multi_errors' limits, as is the twin."""
    ref = runs["plain"][1]

    def differing(got) -> list:
        return [k for kind in ("grads", "stats") for k, r in ref[kind].items()
                if not torch.equal(got[kind][k], r)] + [
            k for k, v in ref["logs"].items() if got["logs"][k] != v]

    nccl, twin = differing(runs["nccl"][1]), differing(runs["twin"][1])
    print(f"phase 21 NCCL world size 1 {what}: bit for bit {not nccl} ({len(nccl)} tensors "
          f"differ); the single-card step against itself: bit for bit {not twin} ({len(twin)} "
          f"differ)", flush=True)
    out = {"bitwise": not nccl, "differing": len(nccl), "twin_bitwise": not twin,
           "twin_differing": len(twin)}
    if nccl:
        if not twin:
            fail(f"phase 21 NCCL world size 1 {what}: the card repeats the single-card step bit "
                 f"for bit, the NCCL step differs in {nccl[:5]}")
        out["twin_errors"] = multi_errors(runs["twin"][1], ref, f"phase 21 {what} single-card twin",
                                          gan)
        out["errors"] = multi_errors(runs["nccl"][1], ref, f"phase 21 {what} NCCL world size 1",
                                     gan)
    return out


def multi_serving(syn, preset, make_mesh) -> dict:
    """Two replicas of cuda:0 against the plain call: bf16 B4 x 240 ragged
    and f32 B1 x 96 (one pad row); PCM16 within 1 step, units equal; p50 of
    5 calls each way (one card shared by two replica threads)."""
    cfg = preset("multi_target")
    read = {}
    for dtype, b, frames, lens in MULTI_SERVING:
        pipe = syn.Lip2SpeechPipeline.initialize_random(cfg, compute_dtype=dtype, emit_int16=True)
        req = request(cfg, b, frames, lens, seed=22)
        plain = pipe.synthesise_batch(*req)
        plain_p50 = p50_ms(pipe, req, calls=5)[0]
        pipe.set_mesh(make_mesh(devices=["cuda:0", "cuda:0"]))
        meshed = pipe.synthesise_batch(*req)
        check_results(meshed, lens, "phase 21 serving mesh")
        mesh_p50 = p50_ms(pipe, req, calls=5)[0]
        pipe.set_mesh(None)
        diff = max(pcm_diff(a.wav, c.wav) for a, c in zip(plain, meshed))
        units = all(np.array_equal(a.units, c.units) for a, c in zip(plain, meshed))
        what = f"{'bf16' if dtype else 'f32'} B{b}x{frames}"
        print(f"phase 21 serving {what} on two replicas of cuda:0 (one card shared): PCM16 max "
              f"difference {diff}, units equal {units}; p50 {mesh_p50:.2f} ms against "
              f"{plain_p50:.2f} plain", flush=True)
        if diff > 1 or not units:
            fail(f"phase 21 serving {what}: the two-replica mesh differs from the plain call")
        read[what] = {"pcm16_max_diff": diff, "p50_ms": mesh_p50, "plain_p50_ms": plain_p50}
        del pipe
        torch.cuda.empty_cache()
    return read


PRETRAIN_LENS = (250, 200, 150, 100)    # valid frames of the ragged batch-4 pretraining batch
PRETRAIN_TOL = 1e-4                     # of max |ref|: logits against plain; card against CPU
PRETRAIN_FAULT = 1 + 1e-3               # the faulty attention's scale, which the check must see
PRETRAIN_KW = dict(audio_feat_dim=104, modality_dropout=0.5, audio_dropout=0.5, dropout=0.0)


def pretrain_batch(tp, lens, t: int, dev, seed: int) -> dict:
    """A ragged pretraining batch: video (B, T, 88, 88, 1) with the masked
    frames zeroed, stacked audio features (B, T, 104), the span mask of
    the port's compute_mask_indices (mask_prob 0.3, length 5, over each
    row's valid frames), targets in [0, 500)."""
    from lip2speech_tpu_torch.ops.masking import compute_mask_indices

    rng = np.random.default_rng(seed)
    b = len(lens)
    frames_mask = np.arange(t)[None, :] < np.array(lens)[:, None]
    span = compute_mask_indices((b, t), frames_mask.astype(np.int32), 0.3, 5, rng)
    video = torch.from_numpy(rng.standard_normal((b, t, 88, 88, 1), dtype=np.float32)).to(dev)
    span_t = torch.from_numpy(span).to(dev)
    return {"video": tp.mask_video_frames(video, span_t),
            "audio": torch.from_numpy(rng.standard_normal((b, t, 104), dtype=np.float32)).to(dev),
            "frames_mask": torch.from_numpy(frames_mask).to(dev), "span_mask": span_t,
            "targets": torch.from_numpy(rng.integers(0, 500, (b, t))).to(dev)}


def pretrain_forward(tp, model, batch: dict, gen=None):
    """The model's outputs and pretrain_loss, each inside its annotate range."""
    from lip2speech_tpu_torch.utils.profiling import annotate

    with annotate("forward"):
        out = model(batch["video"], batch["frames_mask"], batch["span_mask"],
                    audio=batch["audio"], gen=gen)
    with annotate("loss"):
        loss, logs = tp.pretrain_loss(out, batch["targets"])
    return out, loss, logs


def pretrain_step(tp, model, opt, batch: dict, gen) -> dict:
    """One Adam step of pretrain_loss (tests/test_pretrain.py's loop);
    returns the logs as floats."""
    from lip2speech_tpu_torch.utils.profiling import annotate

    opt.zero_grad(set_to_none=True)
    _, loss, logs = pretrain_forward(tp, model, batch, gen)
    with annotate("backward"):
        loss.backward()
    opt.step()
    return {"loss": float(loss.detach()), **{k: float(v.detach()) for k, v in logs.items()}}


def pretrain_grads(tp, model, batch: dict, seed: int) -> dict:
    """One forward and backward of pretrain_loss without an update: logits,
    loss, logs and the gradients by name (the modality-dropout draws from a
    generator seeded with `seed`)."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=batch["video"].device).manual_seed(seed)
    out, loss, logs = pretrain_forward(tp, model, batch, gen)
    loss.backward()
    return {"logits": out["logits"].detach(), "loss": float(loss.detach()),
            "logs": {k: float(v.detach()) for k, v in logs.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def worst_grad_err(got: dict, ref: dict) -> tuple[float, str]:
    """Phase 13's measure: the larger of a tensor's largest error over the
    step's largest gradient element and its error's 2-norm over the whole
    gradient's 2-norm, worst over the tensors, with its name."""
    top = max(float(g.abs().max()) for g in ref.values())
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in ref.values()))
    errs = {n: max(float((got[n] - r).abs().max()) / top,
                   float((got[n] - r).double().norm()) / norm) for n, r in ref.items()}
    name = max(errs, key=errs.get)
    return errs[name], name


@contextlib.contextmanager
def plain_attention_fn(att):
    """ops.attention with AttentionFn replaced by the plain reference_attention."""
    real = att.AttentionFn
    att.AttentionFn = type("PlainAttentionFn", (), {"apply": staticmethod(att.reference_attention)})
    try:
        yield
    finally:
        att.AttentionFn = real


def pretrain_against_plain(tp, counters, model, batch, plain: dict, twin_err: float,
                           what: str) -> dict:
    """One kernel step's logits, loss and gradients against the plain
    step's: logits within PRETRAIN_TOL of max |ref|, the loss within
    PRETRAIN_TOL relative, the worst gradient error within ten times the
    ulp twin's. Returns the readings and whether they pass."""
    for c in counters.values():
        c.launches = 0
    got = pretrain_grads(tp, model, batch, seed=1)
    launches = {n: c.launches for n, c in counters.items() if c.launches}
    logits_err = rel_max_err(got["logits"].cpu().numpy(), plain["logits"].cpu().numpy())
    g_err, at = worst_grad_err(got["grads"], plain["grads"])
    read = {"logits_err": logits_err, "loss_rel_err": abs(got["loss"] - plain["loss"]) / abs(plain["loss"]),
            "grad_err": g_err, "grad_err_at": at, "twin_grad_err": twin_err, "launches": launches}
    read["ok"] = (logits_err <= PRETRAIN_TOL and read["loss_rel_err"] <= PRETRAIN_TOL
                  and g_err <= 10 * twin_err)
    print(f"pretrain {what} against the plain step: logits max err / max |ref| {logits_err:.3e} "
          f"(tol {PRETRAIN_TOL:g}), loss rel err {read['loss_rel_err']:.3e} (tol {PRETRAIN_TOL:g}), "
          f"worst gradient err "
          f"{g_err:.3e} at {at} (ten times the ulp twin's: {10 * twin_err:.3e}); launches {launches}; "
          f"{'passes' if read['ok'] else 'fails'}", flush=True)
    return read


def optional_modules_on_card(dev) -> dict:
    """Conv1dResNetFrontend (prelu, swish) on 2 x 4 s of 16 kHz and
    ShuffleNet3DFrontend at B2 x T50, in eval and training mode; VQQuantizer
    on 2 x 1 s and three VQBottleneck EMA updates with a dead code (drawn
    from CPU generators of one seed on both sides); each on the card
    against the CPU within PRETRAIN_TOL of max |ref|."""
    import copy

    from lip2speech_tpu_torch.models import resnet1d, shufflenet, vq
    from lip2speech_tpu_torch.models.layers import init_weights

    rng = np.random.default_rng(5)
    errs = {}

    def both(module, fn):
        init_weights(module, torch.Generator().manual_seed(0))
        card = copy.deepcopy(module).to(dev)
        with torch.no_grad():
            return fn(module, "cpu"), fn(card, dev)

    wav = rng.standard_normal((2, 4 * 16_000, 1), dtype=np.float32)
    crops = rng.standard_normal((2, 50, 88, 88, 1), dtype=np.float32)
    for name, module, x in (("resnet1d_prelu", resnet1d.Conv1dResNetFrontend("prelu"), wav),
                            ("resnet1d_swish", resnet1d.Conv1dResNetFrontend("swish"), wav),
                            ("shufflenet", shufflenet.ShuffleNet3DFrontend(), crops)):
        for mode in ("eval", "train"):
            ref, got = both(module, lambda m, d: m.train(mode == "train")(
                torch.from_numpy(x).to(d)).cpu().numpy())
            errs[f"{name}_{mode}"] = rel_max_err(got, ref)
    lat = rng.standard_normal((2, 16_000, 1), dtype=np.float32)
    ref, got = both(vq.VQQuantizer(),
                    lambda m, d: m.eval()(torch.from_numpy(lat).to(d))[0].cpu().numpy())
    errs["vq_quantizer"] = rel_max_err(got, ref)
    xs = [rng.standard_normal((2, 500, 128), dtype=np.float32) for _ in range(3)]

    def ema(m, d):
        m.train()
        with torch.no_grad():
            m.codebook[-1] = 50.0                       # a code no input is near: dead at once
            m.ema_sum[-1] = 50.0
            m.ema_count[-1] = 1e-3
        gen = torch.Generator().manual_seed(11)
        codes = [m(torch.from_numpy(x).to(d), gen)[0].cpu().numpy() for x in xs]
        return codes, {k: v.cpu().numpy() for k, v in m.state_dict().items()}

    (codes_ref, sd_ref), (codes, sd) = both(vq.VQBottleneck(), ema)
    if not all(np.array_equal(a, b) for a, b in zip(codes, codes_ref)):
        fail("VQBottleneck on the card: codes differ from the CPU's")
    for k in sd_ref:
        errs[f"vq_ema_{k}"] = rel_max_err(sd[k], sd_ref[k])
    if np.isclose(sd["codebook"][-1], 50.0).any():
        fail("VQBottleneck on the card: the dead code was not restarted")
    print(f"pretrain: optional modules, card against CPU, max err / max |ref|: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {PRETRAIN_TOL:g})", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= PRETRAIN_TOL}
    if bad:
        fail(f"optional modules on the card disagree with the CPU: {bad}")
    return errs


def phase_pretrain(counters: dict) -> dict:
    """Phase 22: AV-HuBERT masked-prediction pretraining at full width on the
    card, f32 with TF32 off, random weights from seed 0.

    1. AVHubertPretrainModel at its class defaults (dim 1024, 16 heads, ffn
       4096, 24 layers, final_dim 256, 500 classes, logit_temp 0.1) with the
       audio modality (104 features), modality dropout 0.5, audio dropout
       0.5 and dropout 0, in training mode; a batch of 4 x 250 frames
       (ragged 250/200/150/100), 88 x 88 video, span masks at 0.3 x length
       5; exactly 24 attention launches a forward and a step, no other
       kernel.
    2. Before any update: one step's logits, loss and gradients by name
       against the same step with AttentionFn replaced by the plain
       reference attention: logits within PRETRAIN_TOL of max |ref|, the
       loss within PRETRAIN_TOL relative, the worst gradient error
       (worst_grad_err) within ten times what a twin of the plain step from
       weights one ulp away reads (phase 13's yardstick); an attention
       kernel 0.1% off (scaled_kernel) must fail that check.
    3. Three Adam steps (lr 1e-3): step p50, peak memory, a profiled step
       (device busy ms, the attention kernel's share), one step inside
       utils.profiling.device_trace with annotate ranges around forward,
       loss and backward, which the trace must hold beside the attention
       kernel (in a temporary directory).
    4. At B1 x 50 in eval mode, the card's logits, loss and logs against the
       port's CPU path on the same weights, within PRETRAIN_TOL of max |ref|.
    5. optional_modules_on_card."""
    import tempfile

    from lip2speech_tpu_torch.models import avhubert_pretrain as tp
    from lip2speech_tpu_torch.models.layers import init_weights
    from lip2speech_tpu_torch.ops import attention as att
    from lip2speech_tpu_torch.utils.profiling import device_trace

    t_phase = time.perf_counter()
    set_tf32(False)
    dev = torch.device("cuda")
    with torch.device(dev):
        model = tp.AVHubertPretrainModel(**PRETRAIN_KW)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    model.train()
    layers = model.encoder.n_layers
    n_params = sum(p.numel() for p in model.parameters())
    batch = pretrain_batch(tp, PRETRAIN_LENS, max(PRETRAIN_LENS), dev, seed=0)
    read = {"parameters": n_params, "batch": f"{len(PRETRAIN_LENS)}x{max(PRETRAIN_LENS)} "
            f"ragged {list(PRETRAIN_LENS)}", "masked_frames": int(batch["span_mask"].sum())}
    print(f"pretrain: AVHubertPretrainModel {n_params / 1e6:.1f} M parameters, {layers} layers; "
          f"batch {read['batch']}, {read['masked_frames']} masked frames", flush=True)

    # 2. the kernel's step against the plain step, before any update
    with plain_attention_fn(att):
        plain = pretrain_grads(tp, model, batch, seed=1)
        saved = [p.detach().clone() for p in model.parameters()]
        noise = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, device=dev, generator=noise))
        twin = pretrain_grads(tp, model, batch, seed=1)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        del saved
    twin_err, twin_at = worst_grad_err(twin["grads"], plain["grads"])
    print(f"pretrain ulp twin (plain path, weights one ulp away): worst gradient err {twin_err:.3e} "
          f"at {twin_at}", flush=True)
    del twin
    read["against_plain"] = pretrain_against_plain(tp, counters, model, batch, plain, twin_err,
                                                   "kernel")
    if not read["against_plain"]["ok"] or read["against_plain"]["launches"] != {"attention": layers}:
        fail("pretraining on the attention kernel disagrees with the plain step")
    with scaled_kernel(att, "attention_kernel", PRETRAIN_FAULT):
        faulty = pretrain_against_plain(tp, counters, model, batch, plain, twin_err,
                                        f"attention x {PRETRAIN_FAULT}")
    if faulty["ok"]:
        fail("the pretraining check did not see an attention kernel 0.1% off")
    read["faulty_grad_err"] = faulty["grad_err"]
    del plain
    model.zero_grad(set_to_none=True)

    # 3. three Adam steps, a profiled one and a traced one
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    times, logs = [], []
    for i in range(3):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs.append(pretrain_step(tp, model, opt, batch, gen))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = {n: c.launches for n, c in counters.items()}
        print(f"pretrain step {i + 1}: step_ms {times[-1]:.1f} launches {counts} logs "
              f"{ {k: round(v, 4) for k, v in logs[-1].items()} }", flush=True)
        read["launches_a_step"] = {n: k for n, k in counts.items() if k}
        if counts != {n: layers if n == "attention" else 0 for n in counters}:
            fail(f"pretrain step: expected {layers} attention launches and no other, got {counts}")
        if not all(math.isfinite(v) for v in logs[-1].values()):
            fail(f"pretrain step: non-finite logs {logs[-1]}")
    for c in counters.values():
        c.launches = 0
    with torch.no_grad():
        pretrain_forward(tp, model, batch, gen)
    read["launches_a_forward"] = {n: c.launches for n, c in counters.items() if c.launches}
    if read["launches_a_forward"] != {"attention": layers}:
        fail(f"pretrain forward: launches {read['launches_a_forward']}")
    read["steps"] = logs
    read["step_ms"] = times
    read["step_p50_ms"] = float(np.median(times))
    read["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    by_name, stats = {}, {}
    read["busy_ms"] = profile_call(lambda: pretrain_step(tp, model, opt, batch, gen),
                                   "pretrain step 4x250 f32", by_name=by_name, stats=stats)
    if not read["busy_ms"] > 0:
        fail("pretrain: the profiler saw no device time")
    read["attention_ms"] = sum(ms for k, ms in by_name.items()
                               if "attention_wgmma" in k and "rel_" not in k)
    read["attention_share"] = read["attention_ms"] / max(read["busy_ms"], 1e-9)
    read["profiled_wall_ms"], read["device_launches"] = stats["wall_ms"], stats["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            pretrain_step(tp, model, opt, batch, gen)
            torch.cuda.synchronize()
        files = list(Path(tmp).glob("*.pt.trace.json"))
        events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
        read["trace_mb"] = files[0].stat().st_size / 2 ** 20 if files else 0.0
    names = {e.get("name", "") for e in events}
    read["trace_ranges"] = sorted(names & {"forward", "loss", "backward"})
    read["trace_attention_kernels"] = sum(1 for e in events if e.get("cat") == "kernel"
                                          and "attention_wgmma" in e.get("name", ""))
    print(f"pretrain: device_trace wrote {len(files)} file(s), {read['trace_mb']:.1f} MiB; annotate "
          f"ranges {read['trace_ranges']}; attention kernels in it {read['trace_attention_kernels']}",
          flush=True)
    if read["trace_ranges"] != ["backward", "forward", "loss"] or read["trace_attention_kernels"] != layers:
        fail("the device trace lacks the annotate ranges or the attention kernel")
    print(f"pretrain 4x250 f32 (TF32 off): step_ms {[round(t, 1) for t in times]} p50 "
          f"{read['step_p50_ms']:.1f}; busy {read['busy_ms']:.1f} ms, share "
          f"{read['busy_ms'] / read['profiled_wall_ms']:.3f}, {read['device_launches']} device launches; "
          f"attention {read['attention_ms']:.3f} ms = {100 * read['attention_share']:.2f}% of busy; "
          f"peak memory {read['peak_gib']:.2f} GiB", flush=True)
    del opt

    # 4. the card against the CPU at B1 x 50, eval mode
    small = pretrain_batch(tp, (50,), 50, "cpu", seed=3)
    cpu = tp.AVHubertPretrainModel(**PRETRAIN_KW)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()}, strict=True)
    results = {}
    for who, m, b in (("cpu", cpu.eval(), small),
                      ("card", model.eval(), {k: v.to(dev) for k, v in small.items()})):
        with torch.no_grad():
            out, loss, logs = pretrain_forward(tp, m, b)
        results[who] = {"logits": out["logits"].cpu().numpy(), "loss": float(loss),
                        **{k: float(v) for k, v in logs.items()}}
    del cpu
    ref, got = results["cpu"], results["card"]
    errs = {k: rel_max_err(np.asarray(got[k]), np.asarray(ref[k])) if np.any(ref[k])
            else float(abs(got[k])) for k in ref}
    read["card_against_cpu"] = errs
    print(f"pretrain B1x50 eval, card against CPU: max err / max |ref| "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol {PRETRAIN_TOL:g})", flush=True)
    if not all(v <= PRETRAIN_TOL for v in errs.values()):
        fail("pretraining on the card disagrees with the CPU")
    del model, batch
    torch.cuda.empty_cache()

    # 5. the optional modules
    read["optional_modules"] = optional_modules_on_card(dev)
    read["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22 pretraining and the optional modules: {read['seconds']:.1f} s", flush=True)
    print(json.dumps({"pretrain": read}, default=float), flush=True)
    return read


# phase 23: the dataset tools and the capacity probe
DATASET_LENS = (40, 48, 56, 64)   # frames of the 4 raw 240 x 320 clips
DATASET_TOL = 1e-4                # mel, d-vectors, denoised wavs: card vs CPU, of max |ref|
PROBE_SECONDS = (24.0, 4.0)       # find_max_duration's default cap and step
PROBE_CHECK_SECONDS = 8.0         # the probe held against the plain path on the CPU


def raw_dataset_clips(root: Path, seed: int = 0) -> tuple[list, list, list]:
    """The recipe of tests/test_create_dataset_full.py at DATASET_LENS: raw
    240 x 320 .npy frames (dark noise with a bright 7 x 7 patch at the
    mouth), 68-point landmark .npy files (the mean face shifted a pixel a
    frame) and sine wavs of 640 samples a frame. Returns the three path
    lists."""
    from lip2speech_tpu_torch.pipeline.mouth_crop import default_mean_face
    from lip2speech_tpu_torch.utils.audio_io import write_wav

    root.mkdir(parents=True, exist_ok=True)
    mean_face = default_mean_face()
    rng = np.random.default_rng(seed)
    videos, lms_files, audios = [], [], []
    for c, t in enumerate(DATASET_LENS):
        frames = rng.integers(0, 40, (t, 240, 320), dtype=np.uint8)
        lms = []
        for i in range(t):
            lm = mean_face * 0.9 + np.array([70 + 5 * c + i % 30, 40])
            mx, my = (int(v) for v in lm[48:68].mean(axis=0))
            frames[i, my - 3: my + 4, mx - 3: mx + 4] = 255
            lms.append(lm)
        np.save(root / f"c{c}.npy", frames)
        np.save(root / f"c{c}.lms.npy", np.stack(lms))
        sig = 0.3 * np.sin(2 * np.pi * (180 + 40 * c) * np.arange(t * 640) / 16_000)
        write_wav(root / f"c{c}.wav", sig + 0.01 * rng.standard_normal(sig.size), 16_000)
        videos.append(str(root / f"c{c}.npy"))
        lms_files.append(str(root / f"c{c}.lms.npy"))
        audios.append(str(root / f"c{c}.wav"))
    return videos, lms_files, audios


def dataset_video(path: Path, n_frames: int) -> None:
    """A video for overlay to pair a wav with: an mp4 of n_frames 96 x 96
    frames written with cv2 where cv2 is installed, else an empty file of
    that name (a machine without cv2 has no libav to mux with either)."""
    try:
        import cv2
    except ImportError:
        path.write_bytes(b"")
        return
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (96, 96))
    for i in range(n_frames):
        writer.write(np.full((96, 96, 3), 4 * i % 256, np.uint8))
    writer.release()


def dataset_tree_errors(got: Path, ref: Path) -> dict:
    """Two `create_dataset init` trees: equal file lists (else fail); the
    worst error of the mels and d-vectors over max |ref|, and the number of
    other files (crops, wavs, label files up to their root line) that are
    not equal byte for byte."""
    files = files_under(ref)
    if files_under(got) != files:
        fail(f"create_dataset: the trees differ: {files_under(got)} on the card, {files} on "
             f"the CPU")
    errs = {"mel": 0.0, "spk_emb": 0.0, "unequal_files": 0}
    for rel in files:
        top = rel.parts[0]
        if top in ("mel", "spk_emb"):
            errs[top] = max(errs[top], rel_max_err(np.load(got / rel), np.load(ref / rel)))
        elif top == "label":
            same = ((got / rel).read_text().replace(str(got), "ROOT")
                    == (ref / rel).read_text().replace(str(ref), "ROOT"))
            errs["unequal_files"] += not same
        else:
            errs["unequal_files"] += (got / rel).read_bytes() != (ref / rel).read_bytes()
    return errs


def phase_dataset_tools(syn, counters: dict, preset, smi: str) -> dict:
    """The dataset and capacity tools through their entry points at the full
    width of multi_target, in a temporary directory removed after:
    create_dataset init (4 raw clips with landmarks, a random GE2E encoder,
    --workers 2) on the card against the same command with --device cpu;
    train_stage1 for one update of batch 2 on that tree (exactly 12
    rel_attention and 12 rel_attention_bwd launches); infer from the
    update's file, the card against the CPU (the mels at CLI_REL_TOL, units
    differing only at near-ties); create_dataset vocoder on both infer
    outputs; vocode (a random generator) on the card's; overlay
    --denoise-and-normalise over those wavs on the card against the CPU;
    find_max_duration to its 24 s cap in 4 s steps, f32 with TF32 off:
    every probe ok with exactly 12 rel_attention and 4 fused trio launches a
    forward (two forwards a probe, as the tool warms up once), the 8 s
    probe's waveform against the same weights' plain path on the CPU
    (phase 5's limit), and a forward that raises an error other than out of
    memory fails the tool. Returns the launches of each kernel by tool."""
    from lip2speech_tpu_torch import native
    from lip2speech_tpu_torch.cli import create_dataset, find_max_duration, infer, overlay
    from lip2speech_tpu_torch.cli import train_stage1, vocode
    from lip2speech_tpu_torch.data.stage1 import pick_bucket
    from lip2speech_tpu_torch.models.layers import init_weights
    from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator
    from lip2speech_tpu_torch.utils.audio_io import read_wav

    cfg = preset("multi_target")
    layers, n_trio = cfg.model.conformer.layers, n_trio_stages(cfg.vocoder)
    seconds, launches, read = {}, {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_") as tmp:
        tmp = Path(tmp)
        videos, lms, audios = raw_dataset_clips(tmp / "raw")

        # 1. create_dataset init on the card, then the same on the CPU
        set_tf32(False)
        init = ["init", "--videos", *videos, "--audios", *audios, "--landmarks", *lms,
                "--speaker-encoder", "random", "--split", "test"]
        utts, seconds["init"], _, launches["init"] = run_counted(
            counters, lambda: create_dataset.main(init + ["--workers", "2", "--out-root",
                                                          str(tmp / "ds")]),
            {}, "create_dataset init")
        t0 = time.perf_counter()
        create_dataset.main(init + ["--out-root", str(tmp / "ds_cpu"), "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        errs = dataset_tree_errors(tmp / "ds", tmp / "ds_cpu")
        read["init"] = errs
        print(f"create_dataset init: {len(utts)} clips of {DATASET_LENS} frames, 240 x 320 -> "
              f"{np.load(tmp / 'ds' / 'video/test/clip/00000.npy').shape} crops; card against "
              f"CPU: mel {errs['mel']:.3e}, d-vector {errs['spk_emb']:.3e} of max |ref| (tol "
              f"{DATASET_TOL:g}), {errs['unequal_files']} crops / wavs / label files unequal; "
              f"CPU run {cpu_s:.2f} s", flush=True)
        if (errs["unequal_files"] or not errs["mel"] <= DATASET_TOL
                or not errs["spk_emb"] <= DATASET_TOL or [u.n_frames for u in utts]
                != list(DATASET_LENS)):
            fail("create_dataset init: the card's tree disagrees with the CPU's")

        # 2. one stage-1 update on that tree, infer, create_dataset vocoder
        torch.backends.cuda.matmul.allow_tf32 = False       # torch's defaults for training
        torch.backends.cudnn.allow_tf32 = True
        label = tmp / "ds" / "label"
        tsv, unt = str(label / "test.tsv"), str(label / "test.unt")
        state, seconds["train_stage1"], _, launches["train_stage1"] = run_counted(
            counters, lambda: train_stage1.main(
                ["--preset", "multi_target", "--train-tsv", tsv, "--train-unt", unt,
                 "--checkpoint-dir", str(tmp / "s1"), "--batch-size", "2", "--update-freq", "1",
                 "--max-updates", "1", "--save-interval", "1", "--log-interval", "1"]),
            {"rel_attention": layers, "rel_attention_bwd": layers}, "train_stage1 --max-updates 1")
        if state.step != 1:
            fail(f"train_stage1: step {state.step} after one update")
        del state
        torch.cuda.empty_cache()
        set_tf32(False)
        ckpt_file = str(tmp / "s1" / "s1_00000001.pt")
        n_batches = sum(-(-c // 4) for c in Counter(pick_bucket(n) for n in DATASET_LENS).values())
        infer_args = ["--preset", "multi_target", "--checkpoint", ckpt_file, "--tsv", tsv,
                      "--unt", unt, "--batch-size", "4"]
        stats, seconds["infer"], _, launches["infer"] = run_counted(
            counters, lambda: infer.main(infer_args + ["--results-path", str(tmp / "inf")]),
            {"rel_attention": layers * n_batches}, "infer")
        t0 = time.perf_counter()
        infer.main(infer_args + ["--results-path", str(tmp / "inf_cpu"), "--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        from lip2speech_tpu_torch.convert.from_reference import load_stage1_weights

        mel_err = infer_mel_err(tmp / "inf", tmp / "inf_cpu")
        n_pos, n_diff = unit_flips_within_ties(cfg, load_stage1_weights(ckpt_file, cfg.model),
                                               label, tmp / "inf", tmp / "inf_cpu", split="test")
        read["infer"] = {"mel": mel_err, "unit_positions": n_pos, "units_differ": n_diff}
        print(f"infer from the update's s1_: {stats['n_utts']} utterances, n_failed "
              f"{stats['n_failed']}; mel error vs CPU {mel_err:.3e} of max |mel| (tol "
              f"{CLI_REL_TOL:g}); units differ at {n_diff} of {n_pos} positions (near-ties "
              f"only); CPU run {cpu_s:.2f} s", flush=True)
        if (stats["n_failed"] or stats["n_utts"] != len(DATASET_LENS)
                or files_under(tmp / "inf") != files_under(tmp / "inf_cpu")
                or not mel_err <= CLI_REL_TOL):
            fail("infer: the card's artifacts disagree with the CPU's")
        for side in ("", "_cpu"):
            create_dataset.main(["vocoder", "--dataset-root", str(tmp / "ds"), "--synthesis-dir",
                                 str(tmp / f"inf{side}"), "--out-root", str(tmp / f"voc{side}")])
        voc_files = files_under(tmp / "voc")
        voc_mel = max(rel_max_err(np.load(tmp / "voc" / r), np.load(tmp / "voc_cpu" / r))
                      for r in voc_files if r.parts[0] == "mel")
        unequal = [r for r in voc_files if r.parts[0] in ("audio", "spk_emb")
                   and (tmp / "voc" / r).read_bytes() != (tmp / "voc_cpu" / r).read_bytes()]
        rows = [np.array(line.split(), int) for line in
                (tmp / "voc" / "label" / "test.unt").read_text().splitlines()]
        rows_cpu = [np.array(line.split(), int) for line in
                    (tmp / "voc_cpu" / "label" / "test.unt").read_text().splitlines()]
        unit_diff = sum(int((a != b).sum()) for a, b in zip(rows, rows_cpu))
        read["vocoder_dir"] = {"files": len(voc_files), "mel": voc_mel, "units_differ": unit_diff}
        print(f"create_dataset vocoder: {len(voc_files)} files, the same list as the CPU's: "
              f"{voc_files == files_under(tmp / 'voc_cpu')}; mel {voc_mel:.3e} of max |ref|; "
              f"audio / spk_emb unequal {len(unequal)}; units differ at {unit_diff} positions "
              f"(infer's near-ties)", flush=True)
        if (voc_files != files_under(tmp / "voc_cpu") or unequal or not voc_mel <= CLI_REL_TOL
                or unit_diff != n_diff or len(rows) != len(DATASET_LENS)):
            fail("create_dataset vocoder: the tree from the card's infer disagrees with the CPU's")

        # 3. vocode the card's tree (a random generator), then overlay its wavs
        gen = MelCodeGenerator(cfg.vocoder)
        init_weights(gen, torch.Generator().manual_seed(1))
        vtsv, vunt = tmp / "voc" / "label" / "test.tsv", tmp / "voc" / "label" / "test.unt"
        _, seconds["vocode"], _, launches["vocode"] = run_counted(
            counters, lambda: vocode.run_vocoder(cfg, gen.state_dict(), vtsv, vunt, tmp / "wav"),
            {"fused_resblock_trio": n_trio * len(DATASET_LENS)}, "vocode.run_vocoder")
        try:
            native.build("media_mux")
            shim = "builds"
        except native.BuildError as e:
            shim = f"does not build ({str(e).splitlines()[0]})"
        for u in utts:                                      # the videos overlay pairs by name
            dataset_video(tmp / "ds" / "video" / f"{u.uid}.mp4", u.n_frames)
        ov = ["--video-dir", str(tmp / "ds" / "video"), "--pred-wav-dir",
              str(tmp / "wav" / "pred_wav"), "--denoise-and-normalise"]
        summary, seconds["overlay"], _, launches["overlay"] = run_counted(
            counters, lambda: overlay.main(ov + ["--out-dir", str(tmp / "ov")]), {}, "overlay")
        overlay.main(ov + ["--out-dir", str(tmp / "ov_cpu"), "--device", "cpu"])
        den = sorted((tmp / "ov").rglob("*_denoised.wav"))
        den_err = max(rel_max_err(read_wav(p)[0], read_wav(tmp / "ov_cpu" / p.relative_to(
            tmp / "ov"))[0]) for p in den)
        read["overlay"] = dict(summary, denoised=len(den), denoise_err=den_err)
        print(f"overlay --denoise-and-normalise: {summary}; the libav mux shim {shim}; "
              f"denoised wavs card against CPU {den_err:.3e} of max |ref| (tol "
              f"{DATASET_TOL:g})", flush=True)
        if summary["pairs"] != len(DATASET_LENS) or len(den) != len(DATASET_LENS) or not (
                den_err <= DATASET_TOL):
            fail("overlay: the card's denoised wavs disagree with the CPU's")
        del gen

        # 4. find_max_duration to its cap, every probe's launches, the 8 s waveform
        set_tf32(False)
        real_probe, probes = find_max_duration.probe, []

        def counted_probe(pipe, secs):
            before = {n: c.launches for n, c in counters.items()}
            result, wav = real_probe(pipe, secs)
            probes.append((pipe, secs, {n: c.launches - before[n] for n, c in counters.items()},
                           wav))
            return result, wav

        cap, step = PROBE_SECONDS
        find_max_duration.probe = counted_probe
        try:
            out, seconds["find_max_duration"], _, launches["find_max_duration"] = run_counted(
                counters, lambda: find_max_duration.main(["--preset", "multi_target"]),
                {"rel_attention": 2 * layers * round(cap / step),
                 "fused_resblock_trio": 2 * n_trio * round(cap / step)}, "find_max_duration")
        finally:
            find_max_duration.probe = real_probe
        per_probe = {"rel_attention": 2 * layers, "fused_resblock_trio": 2 * n_trio}
        for (_, secs, counts, _), res in zip(probes, out["probes"]):
            print(f"find_max_duration probe {secs:g} s ({res['frames']} frames, B1 f32): "
                  f"{res['latency_ms']} ms, real-time factor {res['rtf']}, launches "
                  f"{ {k: n for k, n in counts.items() if n} } | {smi}", flush=True)
            if counts != {n: per_probe.get(n, 0) for n in counters}:
                fail(f"find_max_duration: probe {secs:g} s launched {counts}")
        if out["max_ok_seconds"] != cap or not all(r["ok"] for r in out["probes"]):
            fail(f"find_max_duration: {out}")
        pipe, _, _, wav = next(p for p in probes if p[1] == PROBE_CHECK_SECONDS)
        cpu = syn.Lip2SpeechPipeline(cfg, pipe.model.state_dict(), pipe.vocoder.state_dict(),
                                     device="cpu")
        t0 = time.perf_counter()
        n = int(PROBE_CHECK_SECONDS * 25)
        ref = cpu.forward(torch.zeros(1, n, 88, 88, 1), torch.ones(1, n, dtype=torch.bool),
                          torch.zeros(1, 256))[0][0].numpy()
        probe_err = float(np.abs(wav - ref).max())
        print(f"find_max_duration {PROBE_CHECK_SECONDS:g} s probe's waveform against the plain "
              f"path on the CPU: max_abs_err {probe_err:.3e} (tol 1e-3), |wav| max "
              f"{float(np.abs(ref).max()):.4f}; CPU run {time.perf_counter() - t0:.2f} s",
              flush=True)
        if wav.shape != ref.shape or not probe_err <= 1e-3:
            fail("find_max_duration: the probe's waveform disagrees with the plain path")
        del cpu
        real_forward = pipe.forward
        for exc, ends in ((torch.cuda.OutOfMemoryError("CUDA out of memory (injected)"), True),
                          (RuntimeError("CUDA error: an illegal memory access (injected)"), False)):
            def failing(video, mask, spk, exc=exc):
                if video.shape[1] > 100:
                    raise exc
                return real_forward(video, mask, spk)

            pipe.forward = failing
            try:
                res = find_max_duration.probe_durations(pipe, 12.0, 4.0)
                outcome = f"ends the list at {res['max_ok_seconds']:g} s"
                ok = ends and res["max_ok_seconds"] == 4.0 and not res["probes"][-1]["ok"]
            except RuntimeError as e:
                outcome = f"fails the tool ({e})"
                ok = not ends and not isinstance(e, torch.cuda.OutOfMemoryError)
            print(f"find_max_duration with a forward raising {type(exc).__name__} past 100 "
                  f"frames: {outcome}", flush=True)
            if not ok:
                fail("find_max_duration: an error other than out of memory must fail the tool, "
                     "and out of memory must end the list")
        pipe.forward = real_forward
        read["probes"] = out["probes"]
        read["probe_err"] = probe_err
        del pipe, probes
        torch.cuda.empty_cache()
    seconds["phase"] = time.perf_counter() - t_phase
    read.update(seconds={k: round(v, 3) for k, v in seconds.items()}, launches=launches)
    print(f"phase 23 dataset tools and capacity probe (multi_target, full width): "
          f"{json.dumps(read, default=float)}", flush=True)
    return launches


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
    sass = sass_tensor_core_counts(build)

    counters = kernel_counters()
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
    asr = phase_asr(counters)
    multi = phase_multi_gpu(counters, preset)
    pretrain = phase_pretrain(counters)
    tools = phase_dataset_tools(syn, counters, preset, smi)
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
        if lib == "rel_attention_bwd":
            design = ("one key-major pass, TMA-fed, warp-specialised; bf16: every product on "
                      "wgmma m64n64k16, f32 accumulate; f32: 3xTF32, S, dPr and G on wgmma "
                      "m64nNk8, dK, dV, dQ_u, dQ_v and dP on mma.sync m16n8k8")
        elif lib == "rel_attention_bias_bwd":
            design = ("one key-major pass, TMA-fed, warp-specialised, the bias and dbias in the "
                      "accumulator layout straight from and to device memory; bf16: two score "
                      "warpgroups on alternate query tiles and a gradient warpgroup, every "
                      "product on wgmma m64n64k16, f32 accumulate; f32: 3xTF32, S, dPr and dQ_u "
                      "on wgmma m64nNk8, dK and dV on mma.sync m16n8k8")
        elif lib == "fused_tail":
            design = ("TMA-fed, a producer and two consumer warpgroups; every conv on wgmma, "
                      "A (the activations at each tap's row shift, loaded a step ahead) in "
                      "registers, B (the weights, packed K-major and swizzled by the wrapper) "
                      "from a ring of 16 KB slots by bulk copy; bf16: m64nNk16, f32 "
                      "accumulate; f32: 3xTF32 m64nNk8, the weights split by the wrapper, A "
                      "in registers (at C16 hi and lo stacked into one operand: hi_a against "
                      "both, n32, lo_a against hi, n16)")
        else:
            design = ("flash_fwd_hopper.cuh: TMA-fed, a producer and two consumer warpgroups; "
                      "bf16: 128 query rows a block, every product on wgmma m64nNk16, f32 "
                      "accumulate; f32: 64 rows, 3xTF32 with every product on wgmma m64nNk8, "
                      "the warpgroups on alternate key tiles (attention, rel_attention_bias) or "
                      "32 keys of each tile (rel_attention); rel_attention_bias: each thread's "
                      "bias loaded into the accumulator layout a tile ahead")
        numbers.update(design=design,
                       hmma_in_sass=sass["hmma"][lib], hmma_tf32_in_sass=sass["hmma_tf32"][lib],
                       hgmma_in_sass=sass["hgmma"][lib],
                       hgmma_tf32_in_sass=sass["hgmma_tf32"][lib],
                       cli_launches={tool: n[name] for tool, n in cli.items() if name in n},
                       dataset_tool_launches={tool: n[name] for tool, n in tools.items()
                                              if name in n},
                       server_launches=served.get(name, {}), asr_launches=asr[name],
                       multi_gpu_launches_a_rank={
                           run: multi[run]["rank0"]["launches"].get(name, 0)
                           for run in ("dp2", "tp2", "flagship_tp2", "gan_dp2")})
    plain["pretrain_launches"] = {"forward": pretrain["launches_a_forward"].get("attention", 0),
                                  "step": pretrain["launches_a_step"].get("attention", 0)}
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
