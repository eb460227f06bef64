"""Seq2seq lipreading ASR decode CLI, the avhubert infer_s2s.py equivalent
(JAX reference: cli/infer_asr.py): decodes a manifest with an
AVHubertSeq2Seq model and the beam search (repeat-n-gram blocking, length
penalty), or with --raven a RavenASR model and the joint CTC/attention
search, optionally with LM shallow fusion, and writes hypo.json and, with
transcripts, wer.txt (the artifacts of reference avhubert/infer_s2s.py:
50-318).

    python -m lip2speech_tpu_torch.cli.infer_asr --tsv test.tsv --out-dir decode \
        [--checkpoint asr.pt] [--transcripts refs.json] [--raven --ctc-weight 0.1] \
        [--lm-checkpoint lm.pt --lm-weight 0.3] [--device cpu]

Checkpoints are port files of the model's state_dict ({"model": ...},
read weights-only; scripts/orbax_to_torch.py writes them from a JAX orbax
directory). Without --checkpoint the model gets random weights from seed 0,
built from the flags. Transcripts: a JSON {uid: text}; the WER is the
word-level Levenshtein of eval/metrics.py. Runs on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch


def load_model_weights(path) -> dict[str, torch.Tensor]:
    """The state_dict in a port checkpoint file (weights-only)."""
    from lip2speech_tpu_torch.train import checkpoint

    return checkpoint.load(path)["model"]


def build_model(args, num_classes: int):
    """AVHubertSeq2Seq, or RavenASR with --raven, sized by the flags."""
    if args.raven:
        from lip2speech_tpu_torch.models.raven_asr import RavenASR

        # espnet layout: blank 0, processor ids shifted +1, sos = eos = last
        return RavenASR(RavenASR.from_num_classes(
            num_classes, dim=args.encoder_dim, heads=args.encoder_heads,
            ffn_dim=args.encoder_ffn_dim, layers=args.encoder_layers,
            decoder_layers=args.decoder_layers, decoder_heads=args.decoder_heads))
    from lip2speech_tpu_torch.models.avhubert_asr import AVHubertSeq2Seq, Seq2SeqConfig

    return AVHubertSeq2Seq(Seq2SeqConfig(
        vocab_size=num_classes, encoder_dim=args.encoder_dim,
        encoder_heads=args.encoder_heads, encoder_ffn_dim=args.encoder_ffn_dim,
        encoder_layers=args.encoder_layers, decoder_dim=args.encoder_dim,
        decoder_heads=args.decoder_heads, decoder_ffn_dim=args.decoder_ffn_dim,
        decoder_layers=args.decoder_layers))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tsv", required=True)
    p.add_argument("--root", default=None)
    p.add_argument("--transcripts", default=None, help="JSON {uid: reference text} for WER")
    p.add_argument("--checkpoint", default=None,
                   help="port file of the model's state_dict; omit for random weights")
    p.add_argument("--vocab", default=None, help=".vocab for unigram text; default char-level")
    p.add_argument("--beam", type=int, default=10)
    p.add_argument("--max-len", type=int, default=50)
    p.add_argument("--len-penalty", type=float, default=1.0)
    p.add_argument("--no-repeat-ngram", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--out-dir", required=True)
    # hybrid CTC/attention decoding (the RAVEn eval path; needs --raven)
    p.add_argument("--raven", action="store_true",
                   help="RavenASR model (encoder+CTC+decoder, joint decode)")
    p.add_argument("--ctc-weight", type=float, default=0.0,
                   help="joint CTC/attention weight (RavenASR only)")
    # LM shallow fusion
    p.add_argument("--lm-checkpoint", default=None,
                   help="port file of a TransformerLM's state_dict")
    p.add_argument("--lm-weight", type=float, default=0.0)
    p.add_argument("--lm-dim", type=int, default=512)
    p.add_argument("--lm-heads", type=int, default=8)
    p.add_argument("--lm-ffn-dim", type=int, default=2048)
    p.add_argument("--lm-layers", type=int, default=6)
    # architecture (reference AVHubertSeq2Seq large defaults)
    p.add_argument("--encoder-dim", type=int, default=1024)
    p.add_argument("--encoder-heads", type=int, default=16)
    p.add_argument("--encoder-ffn-dim", type=int, default=4096)
    p.add_argument("--encoder-layers", type=int, default=24)
    p.add_argument("--decoder-heads", type=int, default=4)
    p.add_argument("--decoder-ffn-dim", type=int, default=3072)
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    from lip2speech_tpu_torch.data.stage1 import Stage1Dataset
    from lip2speech_tpu_torch.data.text import SentenceProcessor
    from lip2speech_tpu_torch.eval.metrics import corpus_wer
    from lip2speech_tpu_torch.models.layers import init_weights
    from lip2speech_tpu_torch.pipeline.synthesise import resolve_device

    dev = resolve_device(args.device)
    processor = SentenceProcessor(args.vocab)
    model = build_model(args, processor.num_classes)
    if args.raven and args.no_repeat_ngram:
        print("warning: --no-repeat-ngram is not supported by the joint CTC/attention "
              "decoder; ignoring")
    if args.checkpoint:
        model.load_state_dict(load_model_weights(args.checkpoint), strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval().requires_grad_(False)

    lm_kw = {}
    if args.lm_checkpoint and args.lm_weight:
        from lip2speech_tpu_torch.models.lm import TransformerLM

        vocab = processor.num_classes + 2 if args.raven else processor.num_classes
        lm = TransformerLM(vocab_size=vocab, dim=args.lm_dim, heads=args.lm_heads,
                           ffn_dim=args.lm_ffn_dim, layers=args.lm_layers)
        lm.load_state_dict(load_model_weights(args.lm_checkpoint), strict=True)
        lm_kw = {"lm": lm.to(dev).eval().requires_grad_(False), "lm_weight": args.lm_weight}

    ds = Stage1Dataset(args.tsv, root_override=args.root, train=False)
    transcripts = (json.loads(Path(args.transcripts).read_text())
                   if args.transcripts else {})
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    hypos: dict = {}
    refs, hyps = [], []
    with torch.inference_mode():
        for batch in ds.batches(args.batch_size):
            video = torch.as_tensor(batch["video"], device=dev)
            mask = torch.as_tensor(batch["frames_mask"], device=dev)
            if args.raven:
                nbest, scores = model.decode_joint(
                    video, mask, beam=args.beam, max_len=args.max_len,
                    ctc_weight=args.ctc_weight, len_penalty=args.len_penalty, **lm_kw)
            else:
                nbest, scores = model.decode_beam(
                    video, mask, beam=args.beam, max_len=args.max_len,
                    len_penalty=args.len_penalty, no_repeat_ngram_size=args.no_repeat_ngram,
                    **lm_kw)
            for i, uid in enumerate(batch["ids"]):
                hyp = model.to_text_ids(nbest[i][0]) if args.raven else nbest[i][0]
                text = processor.decode([t for t in hyp if t < processor.num_classes])
                hypos[uid] = {"hypo": text, "score": float(scores[i, 0])}
                if uid in transcripts:
                    hypos[uid]["ref"] = transcripts[uid]
                    refs.append(transcripts[uid])
                    hyps.append(text)

    (out_dir / "hypo.json").write_text(json.dumps(hypos, indent=2))
    wer = None
    if refs:
        wer = corpus_wer(refs, hyps)
        (out_dir / "wer.txt").write_text(f"WER: {100.0 * wer:.2f}\nn_utts: {len(refs)}\n")
        print(f"WER {100.0 * wer:.2f}% over {len(refs)} utts")
    print(f"wrote {out_dir / 'hypo.json'} ({len(hypos)} hypotheses)")
    return {"hypos": hypos, "wer": wer}


if __name__ == "__main__":
    main()
