"""Vocoder inference CLI: stage-2 input tree -> pred_wav/*.wav + RTF (JAX
reference: cli/vocode.py).

Reads the units / mel / speaker manifests, synthesises each utterance in f32
on the card (or with --device cpu on the CPU), writes 16 kHz PCM16 WAVs and
reports the real-time factor.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from lip2speech_tpu_torch.core.config import PipelineConfig, preset
from lip2speech_tpu_torch.data.stage2 import Stage2Dataset
from lip2speech_tpu_torch.models.vocoder import MelCodeGenerator
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device
from lip2speech_tpu_torch.utils.audio_io import write_wav


def run_vocoder(cfg: PipelineConfig, gen_state: dict[str, torch.Tensor], tsv_path, unt_path,
                out_dir, root_override=None, device: str | torch.device | None = None,
                keep_wavs: bool = False) -> dict:
    """gen_state: MelCodeGenerator's state_dict (loaded strict). device None:
    the card. One generator call per utterance. keep_wavs: the stats also
    hold "wavs", {uid: the float waveform before PCM16 quantization}."""
    dev = resolve_device(device)
    gen = MelCodeGenerator(cfg.vocoder)
    gen.load_state_dict(gen_state, strict=True)
    gen.to(dev).eval().requires_grad_(False)
    ds = Stage2Dataset(tsv_path, unt_path, cfg.vocoder, root_override=root_override,
                       train=False)
    out_dir = Path(out_dir)
    total_audio_s = 0.0
    wavs = {}
    t0 = time.time()
    for i in range(len(ds)):
        s = ds.load(i)
        with torch.inference_mode():
            wav = gen(torch.as_tensor(s.code, device=dev).long()[None],
                      torch.as_tensor(s.mel, device=dev)[None],
                      torch.as_tensor(s.spk_emb, device=dev)[None])
        wav = wav[0].cpu().numpy()
        write_wav(out_dir / "pred_wav" / f"{s.uid}.wav", wav, cfg.audio.sample_rate)
        if keep_wavs:
            wavs[s.uid] = wav
        total_audio_s += len(wav) / cfg.audio.sample_rate
    elapsed = time.time() - t0
    rtf = elapsed / max(total_audio_s, 1e-9)
    stats = {"n_utts": len(ds), "audio_s": round(total_audio_s, 2),
             "elapsed_s": round(elapsed, 2), "rtf": round(rtf, 5)}
    return {**stats, "wavs": wavs} if keep_wavs else stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="a port g_* file, or a reference g_* file (converted on load)")
    p.add_argument("--tsv", required=True)
    p.add_argument("--unt", required=True)
    p.add_argument("--root")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--preset", default="multi_target",
                   help="the preset whose vocoder the checkpoint holds")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from lip2speech_tpu_torch.convert.from_reference import load_generator_weights

    cfg = preset(args.preset)
    stats = run_vocoder(cfg, load_generator_weights(args.checkpoint, cfg.vocoder), args.tsv,
                        args.unt, args.out_dir, args.root, device=args.device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
