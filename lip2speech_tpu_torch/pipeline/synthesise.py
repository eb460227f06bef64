"""End-to-end synthesis on the card: mouth video + speaker embedding ->
16 kHz waveform (JAX reference: pipeline/synthesise.py).

    video (B,T,88,88,1) --frontend+conformer--> unit logits (B,2T,204)
                                            +--> mel (B,4T,80)
    units = masked argmax ------------------+
    vocoder(units, mel, spk) ------------------> wav (B, 640*T)

Any of the four stage-1 presets (core/config.py: `multi_target` and its
`_avhubert`, `_auto_avsr`, `_raven` variants) builds from its config. The
pipeline runs on CUDA unless the caller passes device="cpu"; with no card
and no explicit device it raises. On the card the conformer's attention, the
AV-HuBERT trunk's attention and the vocoder's <=128-channel resblock trios
run the hand-written kernels; on the CPU the same modules run their plain
versions.

Data-parallel serving (`set_mesh`, the JAX pipeline's mesh): one replica of
the stage-1 model and the vocoder on each device of the mesh's data axis,
each driven from a persistent thread of its own (cuDNN keeps its plans per
thread). A batch is padded with zero, fully masked rows to a multiple of the
axis, each replica takes its contiguous rows, and the rows come back in
order with the pad rows dropped.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.core.config import PipelineConfig
from lip2speech_tpu_torch.data.stage1 import pick_bucket
from lip2speech_tpu_torch.data.transforms import prepare_video
from lip2speech_tpu_torch.data.video_io import load_video_gray
from lip2speech_tpu_torch.decode.units import argmax_units
from lip2speech_tpu_torch.models.layers import init_weights
from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The caller's device, or CUDA when none is given; never falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                               "the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _bind_thread(dev: torch.device) -> None:
    """A replica thread launches on its own card (the kernels' launches take
    the thread's current device)."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


@dataclass
class SynthesisResult:
    wav: np.ndarray          # (n_samples,) float32 in [-1, 1], or int16 PCM
    units: np.ndarray        # (2 * n_frames,)
    mel: np.ndarray          # (4 * n_frames, 80) float32, or float16 with PCM
    sample_rate: int = 16_000


class Lip2SpeechPipeline:
    """Stage-1 model + vocoder behind one batched call."""

    def __init__(self, cfg: PipelineConfig, stage1_state: dict[str, torch.Tensor],
                 vocoder_state: dict[str, torch.Tensor], compute_dtype: Any = None,
                 emit_int16: bool = False, device: str | torch.device | None = None):
        """stage1_state / vocoder_state: the port's state_dicts (loaded with
        strict=True). compute_dtype=torch.bfloat16 casts every float32 weight
        and buffer (BatchNorm statistics too) and the inputs, as the JAX
        pipeline casts every float32 leaf. emit_int16 returns PCM16 waveforms
        and float16 mels, converted on the device."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.emit_int16 = emit_int16
        self.model = MultiTargetModel(cfg.model)
        self.model.load_state_dict(stage1_state, strict=True)
        self.vocoder = MelCodeGenerator(cfg.vocoder)
        self.vocoder.load_state_dict(vocoder_state, strict=True)
        for m in (self.model, self.vocoder):
            m.eval().requires_grad_(False)
            m.to(device=self.device, dtype=compute_dtype)
        self.mesh = None
        self._replicas: list[tuple] = []      # (model, vocoder, device, thread) per data index

    @classmethod
    def from_jax_variables(cls, cfg: PipelineConfig, s1_variables: dict,
                           vocoder_params: dict, **kwargs) -> "Lip2SpeechPipeline":
        """From the JAX package's trees as nested dicts of numpy arrays:
        stage 1 {"params", "batch_stats"} and the vocoder's params."""
        return cls(cfg, from_jax.stage1_state_dict(s1_variables),
                   from_jax.vocoder_state_dict(vocoder_params), **kwargs)

    @classmethod
    def from_checkpoints(cls, cfg: PipelineConfig, stage1_path: str | Path,
                         vocoder_path: str | Path, compute_dtype: Any = None,
                         emit_int16: bool = False,
                         device: str | torch.device | None = None) -> "Lip2SpeechPipeline":
        """Real-weight pipeline from checkpoint files: each is a port file
        (s1_* / g_*) or a reference .pt converted on load (reference
        inference_server.py:106-176 preloads the published pair the same
        way); both are read weights-only. A JAX orbax directory is converted
        first with scripts/orbax_to_torch.py."""
        from lip2speech_tpu_torch.convert.from_reference import (
            load_generator_weights, load_stage1_weights)

        return cls(cfg, load_stage1_weights(stage1_path, cfg.model),
                   load_generator_weights(vocoder_path, cfg.vocoder),
                   compute_dtype=compute_dtype, emit_int16=emit_int16, device=device)

    @classmethod
    def initialize_random(cls, cfg: PipelineConfig, seed: int = 0,
                          **kwargs) -> "Lip2SpeechPipeline":
        """Random weights from one seeded torch.Generator (made on the CPU,
        so a seed gives the same weights on every machine)."""
        gen = torch.Generator().manual_seed(seed)
        model, vocoder = MultiTargetModel(cfg.model), MelCodeGenerator(cfg.vocoder)
        init_weights(model, gen)
        init_weights(vocoder, gen)
        return cls(cfg, model.state_dict(), vocoder.state_dict(), **kwargs)

    def set_mesh(self, mesh) -> None:
        """Serve over `mesh` (parallel.make_mesh over local devices, model
        axis 1): a copy of both models on each device of its data axis, made
        here once, with a thread of its own. None goes back to one device."""
        for *_, thread in self._replicas:
            thread.shutdown(wait=True)
        self.mesh, self._replicas = mesh, []
        if mesh is None:
            return
        if mesh.distributed or mesh.shape["model"] != 1:
            raise ValueError("serving splits batches over a data axis of local devices "
                             "(make_mesh(devices=...), model=1)")
        for dev in mesh.devices[:, 0]:
            models = [copy.deepcopy(m).to(dev) for m in (self.model, self.vocoder)]
            thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"replica-{dev}",
                                        initializer=_bind_thread, initargs=(dev,))
            self._replicas.append((*models, dev, thread))

    @torch.inference_mode()
    def forward(self, video: torch.Tensor, frames_mask: torch.Tensor,
                spk_emb: torch.Tensor):
        """Device tensors in, device tensors out: (wav, units, mel, mask)."""
        return self._forward(self.model, self.vocoder, video, frames_mask, spk_emb)

    @torch.inference_mode()
    def _forward(self, model, vocoder, video, frames_mask, spk_emb):
        if self.compute_dtype is not None:
            video, spk_emb = video.to(self.compute_dtype), spk_emb.to(self.compute_dtype)
        out = model(video, frames_mask, spk_emb)
        num_special = self.cfg.model.units.num_special
        units = argmax_units(out["unit_logits"], out["mask"], num_special)
        units = torch.where(out["mask"], units, 0)              # pad-safe codes
        wav = vocoder(units, out["mel"], spk_emb)
        if self.emit_int16:
            # float -> int16 truncates toward zero, as JAX's astype does
            wav = torch.clamp(wav.float() * 32767.0, -32768, 32767).to(torch.int16)
            mel = out["mel"].to(torch.float16)
        else:
            wav, mel = wav.float(), out["mel"].float()
        return wav, units, mel, out["mask"]

    @torch.inference_mode()
    def vocode(self, code: np.ndarray, mel: np.ndarray, spk_emb: np.ndarray) -> np.ndarray:
        """The vocoder alone (the reference's standalone vocoder service,
        multi_input_vocoder/inference_server.py:149-215): code (B, Tc) int
        units, mel (B, 2 Tc, 80), spk_emb (B, 256) -> float32 wav (B, Tc *
        code_hop_size), on the pipeline's device and in its dtype."""
        dev, dt = self.device, self.compute_dtype or torch.float32
        wav = self.vocoder(torch.as_tensor(np.asarray(code, np.int64), device=dev),
                           torch.as_tensor(np.asarray(mel, np.float32), device=dev).to(dt),
                           torch.as_tensor(np.asarray(spk_emb, np.float32), device=dev).to(dt))
        return wav.float().cpu().numpy()

    def synthesise_batch(self, video: np.ndarray, frames_mask: np.ndarray,
                         spk_emb: np.ndarray) -> list[SynthesisResult]:
        """video (B, T, 88, 88, 1) normalised; frames_mask (B, T) bool;
        spk_emb (B, 256). Returns one result per request, cut to its length."""
        frames_mask = np.asarray(frames_mask, bool)
        video, spk_emb = np.asarray(video, np.float32), np.asarray(spk_emb, np.float32)
        if self.mesh is None:
            wav, units, mel = self._host_call(self.model, self.vocoder, self.device,
                                              video, frames_mask, spk_emb)
        else:
            wav, units, mel = self._mesh_call(video, frames_mask, spk_emb)
        spf = self.cfg.model.units.mel_per_frame * self.cfg.audio.hop_length
        results = []
        for i in range(frames_mask.shape[0]):
            n = int(frames_mask[i].sum())
            results.append(SynthesisResult(
                wav=wav[i, : n * spf], units=units[i, : 2 * n].astype(np.int32),
                mel=mel[i, : 4 * n], sample_rate=self.cfg.audio.sample_rate))
        return results

    def _host_call(self, model, vocoder, dev, video, frames_mask, spk_emb):
        """Host arrays in, host (wav, units, mel) out, on one device."""
        wav, units, mel, _ = self._forward(
            model, vocoder, torch.as_tensor(video, device=dev),
            torch.as_tensor(frames_mask, device=dev), torch.as_tensor(spk_emb, device=dev))
        return tuple(t.cpu().numpy() for t in (wav, units, mel))

    def _mesh_call(self, video, frames_mask, spk_emb):
        """The batch padded with zero, fully masked rows to a multiple of the
        replicas, each replica's contiguous rows on its thread, the outputs
        in row order (pad rows included: the caller reads only its rows)."""
        from lip2speech_tpu_torch.parallel.mesh import shard_batch

        n = len(self._replicas)
        pad = (-video.shape[0]) % n
        batch = {"video": video, "frames_mask": frames_mask, "spk_emb": spk_emb}
        if pad:
            batch = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                     for k, v in batch.items()}
        futures = []
        for i, (model, vocoder, dev, thread) in enumerate(self._replicas):
            rows = shard_batch(self.mesh, batch, index=i)
            futures.append(thread.submit(self._host_call, model, vocoder, dev, rows["video"],
                                         rows["frames_mask"], rows["spk_emb"]))
        outs = [f.result() for f in futures]
        return tuple(np.concatenate(parts) for parts in zip(*outs))

    def warmup(self, buckets=(48, 96, 160, 240, 360, 480, 600),
               batch_sizes=(1,)) -> None:
        """One call per (batch, bucket): builds the kernels and lets cuDNN
        pick its algorithms before the first request."""
        size = self.cfg.video.mouth_size
        for b in batch_sizes:
            for t in buckets:
                mask = np.zeros((b, t), bool)
                mask[:, 0] = True
                self.synthesise_batch(np.zeros((b, t, size, size, 1), np.float32),
                                      mask, np.zeros((b, self.cfg.model.spk_emb_dim), np.float32))

    def synthesise_file(self, video_path: str | Path, spk_emb: np.ndarray,
                        pad_to_bucket: bool = True) -> SynthesisResult:
        """One mouth-ROI video file (data/video_io.py: a .npy sidecar, .gray,
        or a decodable mp4), cut to cfg.video.max_frames, centre-cropped and
        normalised, padded to its length bucket: one synthesise_batch call."""
        frames = load_video_gray(video_path)[: self.cfg.video.max_frames]
        video = prepare_video(frames, self.cfg.video.mouth_size, train=False)
        n = video.shape[0]
        t = pick_bucket(n) if pad_to_bucket else n
        vb = np.zeros((1, t, video.shape[1], video.shape[2], 1), np.float32)
        vb[0, :n, :, :, 0] = video
        mask = np.zeros((1, t), bool)
        mask[0, :n] = True
        return self.synthesise_batch(vb, mask, spk_emb[None].astype(np.float32))[0]
