"""Synthesis evaluation harness — the reference's headline numbers (the
port's own copy of the JAX package's eval/harness.py; numpy on the host).

Rebuild of test_compare.py:14-130 + the published metric set (README tables,
SURVEY.md §6): for each predicted wav vs its ground-truth wav compute
STOI / ESTOI / (PESQ if installed), and when transcripts + ASR are available
Whisper-WER and viseme distance. Aggregates corpus means.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from lip2speech_tpu_torch.eval import metrics as M
from lip2speech_tpu_torch.utils.audio_io import read_wav


@dataclass
class EvalResult:
    n_utts: int = 0
    stoi: float = 0.0
    estoi: float = 0.0
    pesq: float | None = None
    # schema-enforced caveat: with the in-tree P.862
    # approximation the absolute MOS-LQO is unanchored to the ITU reference
    # binaries — "relative-only" means compare WITHIN this harness, never
    # against published PESQ tables. "itu" when the external package scored.
    pesq_anchor: str | None = None
    wer: float | None = None
    viseme_dist: float | None = None
    per_utt: dict = field(default_factory=dict)

    def to_json(self) -> str:
        d = {k: v for k, v in self.__dict__.items() if k != "per_utt"}
        return json.dumps(d, indent=2)


def evaluate_pair(pred_wav: np.ndarray, gt_wav: np.ndarray,
                  fs: int = 16_000) -> dict:
    n = min(len(pred_wav), len(gt_wav))
    pred, gt = pred_wav[:n], gt_wav[:n]
    out = {"stoi": M.stoi(gt, pred, fs), "estoi": M.estoi(gt, pred, fs)}
    try:
        out["pesq"] = M.pesq_score(gt, pred, fs)
        out["pesq_mode"] = "nb"  # P.862 narrowband MOS-LQO (see metrics.pesq_score)
        impl = M.pesq_impl()
        # relative-only unless the bit-exact ITU package scored it
        out["pesq_anchor"] = "itu" if impl == "itu" else "relative-only"
    except Exception:
        # clip too short for P.862 (<128 ms) raises ValueError from the
        # in-tree path; the optional external `pesq` package raises its own
        # exception types (NoUtterancesError, BufferTooShortError) that are
        # not ValueError subclasses — skip the metric either way.
        pass
    return out


def evaluate_synthesis(
    pred_wav_dir: str | Path,
    gt_manifest_tsv: str | Path,
    root_override=None,
    groundtruth_text: dict[str, str] | None = None,
    asr=None,
) -> EvalResult:
    """pred_wav_dir holds <uid>.wav files parallel to the manifest rows."""
    from lip2speech_tpu_torch.data.manifest import read_manifest

    pred_wav_dir = Path(pred_wav_dir)
    utts = read_manifest(gt_manifest_tsv, root_override=root_override)
    res = EvalResult()
    stois, estois, pesqs, wers, vdists = [], [], [], [], []
    for u in utts:
        pred_path = pred_wav_dir / f"{u.uid}.wav"
        if not pred_path.exists():
            pred_path = pred_wav_dir / f"{Path(u.uid).name}.wav"
        if not pred_path.exists():
            continue
        pred, _ = read_wav(pred_path)
        gt, _ = read_wav(u.audio_path)
        if gt.ndim > 1:
            gt = gt.mean(axis=1)
        try:
            pair = evaluate_pair(pred, gt)
        except ValueError:  # too short for STOI
            continue
        res.per_utt[u.uid] = pair
        stois.append(pair["stoi"])
        estois.append(pair["estoi"])
        if "pesq" in pair:
            pesqs.append(pair["pesq"])

        if asr is not None and groundtruth_text and u.uid in groundtruth_text:
            hyp = asr.run(pred)
            ref_text = groundtruth_text[u.uid]
            w = M.wer(ref_text, hyp)
            v = M.viseme_distance(ref_text, hyp)
            res.per_utt[u.uid].update({"wer": w, "viseme_dist": v, "hyp": hyp})
            wers.append(w)
            vdists.append(v)

    res.n_utts = len(stois)
    if stois:
        res.stoi = float(np.mean(stois))
        res.estoi = float(np.mean(estois))
    if pesqs:
        res.pesq = float(np.mean(pesqs))
        res.pesq_anchor = ("itu" if M.pesq_impl() == "itu"
                           else "relative-only")
    if wers:
        res.wer = float(np.mean(wers))
        res.viseme_dist = float(np.mean(vdists))
    return res


def load_groundtruth_csv(path: str | Path) -> dict[str, str]:
    """Ground-truth CSV: 'Video Name,Phrase' rows (test_compare.py format)."""
    import csv

    out = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            name = row.get("Video Name") or row.get("name")
            phrase = row.get("Phrase") or row.get("text")
            if name and phrase:
                out[name] = phrase
    return out
