"""Batch inference CLI: dataset -> pred_mel/*.npy, pred_unit/*.txt,
hypo-<fid>.json and wer.<fid> (JAX reference: cli/infer.py).

Loads a stage-1 checkpoint (a port s1_*.pt, or a reference .pt converted on
load; both read weights-only, so a fairseq file with a pickled config is
converted first with cli/convert.py), runs the model in f32 over length-bucketed batches on the card (or
with --device cpu on the CPU), writes the reference's artifact layout and
the unit-level WER and accuracy.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from lip2speech_tpu_torch.core.config import PipelineConfig, preset
from lip2speech_tpu_torch.data.prefetch import prefetch
from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
from lip2speech_tpu_torch.decode.units import argmax_units, unit_edit_distance
from lip2speech_tpu_torch.models.multi_target import MultiTargetModel
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device


def run_inference(cfg: PipelineConfig, state_dict: dict[str, torch.Tensor], tsv_path,
                  unt_path, results_path, batch_size: int = 4, root_override=None,
                  suppress_crashes: bool = False, prefetch_depth: int = 3,
                  device: str | torch.device | None = None) -> dict:
    """state_dict: MultiTargetModel's (loaded strict). device None: the card.
    With suppress_crashes a batch that raises is counted in n_failed and
    skipped, as the reference's flag does; off by default."""
    dev = resolve_device(device)
    model = MultiTargetModel(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    model.to(dev).eval().requires_grad_(False)
    num_special = cfg.model.units.num_special
    results_path = Path(results_path)
    (results_path / "pred_mel").mkdir(parents=True, exist_ok=True)
    (results_path / "pred_unit").mkdir(parents=True, exist_ok=True)

    @torch.inference_mode()
    def forward(batch):
        out = model(*(torch.as_tensor(batch[k], device=dev)
                      for k in ("video", "frames_mask", "spk_emb")))
        units = argmax_units(out["unit_logits"], out["mask"], num_special)
        return units.cpu().numpy(), out["mel"].cpu().numpy()

    ds = Stage1Dataset(tsv_path, unt_path, root_override=root_override, train=False)
    result = {"utt_id": [], "ref": [], "hypo": []}
    refs = {u.uid: u.units for u in ds.utts}
    t0 = time.time()
    n_tokens = n_failed = 0
    with prefetch(ds.batches(batch_size), depth=prefetch_depth) as batches:
        for batch in batches:
            try:
                units, mel = forward(batch)
            except Exception:
                if not suppress_crashes:
                    raise
                n_failed += len(batch["ids"])
                continue
            for i, uid in enumerate(batch["ids"]):
                n = int(batch["frames_mask"][i].sum())
                hypo_str = " ".join(str(int(u)) for u in units[i][: 2 * n] if u >= 0)
                ref_units = refs.get(uid)
                ref_str = " ".join(str(int(u)) for u in ref_units) if ref_units is not None else ""
                result["utt_id"].append(uid)
                result["hypo"].append(hypo_str)
                result["ref"].append(ref_str)
                n_tokens += 2 * n
                mel_path = results_path / "pred_mel" / f"{uid}.npy"
                mel_path.parent.mkdir(parents=True, exist_ok=True)
                np.save(mel_path, mel[i][: 4 * n])
                unit_path = results_path / "pred_unit" / f"{uid}.txt"
                unit_path.parent.mkdir(parents=True, exist_ok=True)
                unit_path.write_text(hypo_str)
    elapsed = time.time() - t0

    fid = int(hashlib.md5(str(sorted(result["utt_id"])).encode()).hexdigest(), 16) % 1_000_000
    with open(results_path / f"hypo-{fid}.json", "w") as f:
        json.dump(result, f, indent=4)
    n_err = n_total = n_equal = 0
    for hypo, ref in zip(result["hypo"], result["ref"]):
        h, r = hypo.split(), ref.split()
        n_err += unit_edit_distance([int(x) for x in h], [int(x) for x in r])
        n_equal += sum(a == b for a, b in zip(h, r))
        n_total += len(r)
    wer = 100 * n_err / max(n_total, 1)
    accuracy = 100 * n_equal / max(n_total, 1)
    (results_path / f"wer.{fid}").write_text(
        f"WER: {wer}\nAccuracy: {accuracy}\n"
        f"err / num_ref_words = {n_err} / {n_total}\n\n")
    return {"wer": wer, "accuracy": accuracy, "n_utts": len(result["utt_id"]),
            "n_failed": n_failed, "elapsed_s": elapsed,
            "tokens_per_s": n_tokens / max(elapsed, 1e-9)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="multi_target")
    p.add_argument("--checkpoint", required=True,
                   help="a port s1_*.pt, or a reference stage-1 .pt of tensors only (converted "
                        "on load; a fairseq file with its pickled config: run cli.convert "
                        "first)")
    p.add_argument("--tsv", required=True)
    p.add_argument("--unt")
    p.add_argument("--root")
    p.add_argument("--results-path", required=True)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from lip2speech_tpu_torch.convert.from_reference import load_stage1_weights

    cfg = preset(args.preset)
    stats = run_inference(cfg, load_stage1_weights(args.checkpoint, cfg.model), args.tsv,
                          args.unt, args.results_path, args.batch_size, args.root,
                          device=args.device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
