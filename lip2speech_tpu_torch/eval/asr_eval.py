"""Stand-alone lipreading ASR evaluation, the RAVEn test harness (JAX
reference: eval/asr_eval.py; reference raven/{test.py, finetune_learner.py,
metrics.py}): decode a manifest with a seq2seq lipreading model (beam search,
or the joint CTC/attention search for a model with decode_joint, optionally
with LM shallow fusion) and report the corpus WER.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
from lip2speech_tpu_torch.data.text import SentenceProcessor
from lip2speech_tpu_torch.eval.metrics import corpus_wer
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device


@dataclass
class ASREvalResult:
    wer: float
    n_utts: int
    hypotheses: dict


def evaluate_asr(model, tsv_path: str | Path, transcripts: dict[str, str],
                 processor: SentenceProcessor | None = None, root_override=None,
                 beam: int = 10, max_len: int = 50, lm=None, lm_weight: float = 0.0,
                 ctc_weight: float = 0.0, batch_size: int = 1,
                 device: str | torch.device | None = None) -> ASREvalResult:
    """model: AVHubertSeq2Seq or RavenASR (moved to `device` with the LM;
    None: the card, which must exist)."""
    dev = resolve_device(device)
    model.to(dev).eval()
    processor = processor or SentenceProcessor()
    ds = Stage1Dataset(tsv_path, root_override=root_override, train=False)
    lm_kw = {}
    if lm is not None and lm_weight > 0:
        lm_kw = {"lm": lm.to(dev).eval(), "lm_weight": lm_weight}
    to_text = getattr(model, "to_text_ids", lambda h: h)
    refs, hyps, per_utt = [], [], {}
    with torch.inference_mode():
        for batch in ds.batches(batch_size):
            video = torch.as_tensor(batch["video"], device=dev)
            mask = torch.as_tensor(batch["frames_mask"], device=dev)
            if ctc_weight > 0 and hasattr(model, "decode_joint"):
                nbest, _ = model.decode_joint(video, mask, beam=beam, max_len=max_len,
                                              ctc_weight=ctc_weight, **lm_kw)
            else:
                nbest, _ = model.decode_beam(video, mask, beam=beam, max_len=max_len, **lm_kw)
            for uid, rows in zip(batch["ids"], nbest):
                if uid not in transcripts:
                    continue
                text = processor.decode([t for t in to_text(rows[0])
                                         if t < processor.num_classes])
                refs.append(transcripts[uid])
                hyps.append(text)
                per_utt[uid] = text
    wer = corpus_wer(refs, hyps) if refs else 1.0
    return ASREvalResult(wer=wer, n_utts=len(refs), hypotheses=per_utt)
