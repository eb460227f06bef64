"""Train a subword (unigram) vocabulary from transcripts (JAX reference:
cli/gen_subword.py; pure Python on the host).

Reference: avhubert/preparation/gen_subword.py:31-76 (sentencepiece
trainer + fairseq dict export). Here the unigram model is learned in-tree
(data/spm_train.py) and exported as a .vocab file that data/text.py's
UnigramTokenizer / SentenceProcessor load directly.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> list[tuple[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True,
                    help="text file, one transcript per line "
                         "(or a .csv with a Phrase column)")
    ap.add_argument("--out", required=True, help="output .vocab path")
    ap.add_argument("--vocab-size", type=int, default=1000)
    ap.add_argument("--max-piece-len", type=int, default=8)
    args = ap.parse_args(argv)

    from lip2speech_tpu_torch.data.spm_train import train_unigram, write_vocab

    path = Path(args.input)
    if path.suffix == ".csv":
        import csv

        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        lines = [r.get("Phrase", "") for r in rows]
    else:
        lines = path.read_text(encoding="utf-8").splitlines()
    lines = [ln for ln in lines if ln.strip()]

    pieces = train_unigram(lines, vocab_size=args.vocab_size,
                           max_piece_len=args.max_piece_len)
    write_vocab(args.out, pieces)
    print(f"wrote {len(pieces) + 4} pieces (incl. 4 specials) to {args.out}")
    return pieces


if __name__ == "__main__":
    main()
