"""Text tokenization + CTC decoding for the optional text-supervision branch
(the port's own copy of the JAX package's data/text.py; numpy only).

Rebuild of reference multi_target_lip2speech/helpers.py:15-77
(SentenceProcessor: char-level CHARS with blank=0, or sentencepiece unigram —
implemented IN-TREE as Viterbi over the exported .vocab scores, upgraded to
the sentencepiece package for a .model file when installed) and the
ctcdecode CTC beam search used at decode time (sequence_generator.py:27-38).
"""

from __future__ import annotations

import unicodedata
from pathlib import Path

import numpy as np

# 26 chars + 0-9 + apostrophe + space; '#' = blank at index 0 (reference CHARS)
CHARS = "#abcdefghijklmnopqrstuvwxyz0123456789 '"

WORD_BOUNDARY = "▁"  # ▁ (sentencepiece meta symbol)


class UnigramTokenizer:
    """sentencepiece-unigram encode/decode from an exported .vocab file.

    A trained unigram model segments text by Viterbi search maximizing the
    sum of piece log-probs — exactly the scores sentencepiece exports as the
    second column of the .vocab file (the reference bundles
    multi_target_lip2speech/data/lrs2lrs3_lower.{model,vocab}; ids 0-3 are
    <pad>/<sos>/<eos>/<unk>). This reproduces SentencePieceProcessor.encode
    for that model without the sentencepiece package: NFKC normalization,
    spaces -> ▁ with a dummy leading ▁, DP over pieces, unknown characters
    -> <unk> with the standard penalty (min score - 10).
    """

    def __init__(self, vocab_path: str | Path, unk_piece: str = "<unk>"):
        pieces: list[str] = []
        scores: list[float] = []
        with open(vocab_path, encoding="utf-8") as f:
            for line in f:
                piece, score = line.rstrip("\n").split("\t")
                pieces.append(piece)
                scores.append(float(score))
        self.pieces = pieces
        self.scores = np.asarray(scores)
        self.piece_to_id = {p: i for i, p in enumerate(pieces)}
        self.unk_id = self.piece_to_id.get(unk_piece, 0)
        self.specials = {i for i, p in enumerate(pieces)
                         if p.startswith("<") and p.endswith(">")}
        real = [s for i, s in enumerate(scores) if i not in self.specials]
        self.unk_score = (min(real) if real else -10.0) - 10.0
        self.max_piece_len = max((len(p) for p in pieces), default=1)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    @staticmethod
    def _normalize(text: str) -> str:
        s = unicodedata.normalize("NFKC", text)
        s = " ".join(s.split())                     # collapse whitespace
        return WORD_BOUNDARY + s.replace(" ", WORD_BOUNDARY) if s else ""

    def encode(self, text: str) -> np.ndarray:
        s = self._normalize(text)
        n = len(s)
        if n == 0:
            return np.zeros(0, np.int64)
        best = np.full(n + 1, -np.inf)
        best[0] = 0.0
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        for i in range(n):
            if best[i] == -np.inf:
                continue
            # unknown single character always available
            cand = best[i] + self.unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, self.unk_id)
            for j in range(i + 1, min(n, i + self.max_piece_len) + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is None or pid in self.specials:
                    continue
                cand = best[i] + self.scores[pid]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, pid)
        ids: list[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]  # type: ignore[misc]
            ids.append(pid)
            pos = prev
        return np.asarray(ids[::-1], np.int64)

    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            i = int(i)
            if i == self.unk_id:
                parts.append(" ⁇ ")            # spm renders unk as ⁇
            elif i not in self.specials:
                parts.append(self.pieces[i])
        return "".join(parts).replace(WORD_BOUNDARY, " ").strip()


class SentenceProcessor:
    """Char-level by default; pass a sentencepiece model to match the
    reference's unigram mode (lrs2lrs3_lower.model).

    A `.vocab` path (or a `.model` path with a sibling `.vocab`) runs the
    in-tree UnigramTokenizer; a `.model` path uses the sentencepiece package
    when installed (bit-exact with the trained model's normalizer)."""

    def __init__(self, spm_model: str | None = None):
        self.blank = 0
        self.sp = None
        if spm_model is not None:
            path = Path(spm_model)
            if path.suffix == ".vocab":
                self.sp = UnigramTokenizer(path)
            else:
                try:
                    import sentencepiece as spm  # optional dependency

                    self.sp = spm.SentencePieceProcessor(model_file=str(path))
                except ImportError:
                    vocab = path.with_suffix(".vocab")
                    if not vocab.exists():
                        raise
                    self.sp = UnigramTokenizer(vocab)
        if self.sp is None:
            self.num_classes = len(CHARS)
        elif isinstance(self.sp, UnigramTokenizer):
            self.num_classes = self.sp.vocab_size
        else:
            self.num_classes = self.sp.get_piece_size()

    def encode(self, text: str) -> np.ndarray:
        if self.sp:
            return np.asarray(self.sp.encode(text))
        return np.array([CHARS.index(c) for c in text])

    def decode(self, indices) -> str:
        if isinstance(self.sp, UnigramTokenizer):
            return self.sp.decode(indices)
        if self.sp:
            return self.sp.decode(list(int(i) for i in indices))
        return "".join(CHARS[int(i)] for i in indices)

    def is_valid(self, text: str) -> bool:
        if self.sp:
            return True
        return all(c in CHARS for c in text)

    def collapse_ctc(self, indices) -> str:
        """Greedy CTC collapse: merge repeats, drop blanks."""
        out, prev = [], None
        for i in indices:
            i = int(i)
            if i != prev and i != self.blank:
                out.append(i)
            prev = i
        return self.decode(out)


def ctc_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 25,
    blank: int = 0,
    use_native: bool = True,
) -> tuple[list[int], float]:
    """CTC prefix beam search over (T, C) log-probs.

    Replaces the C++ ctcdecode extension (reference sequence_generator.py:27).
    With use_native it runs the in-tree C implementation (native/ctc_beam.c,
    identical semantics), which raises when it cannot be built; this Python
    body is the reference implementation and the C version's test oracle.
    Returns (best label sequence, its log-probability).
    """
    if use_native:
        from lip2speech_tpu_torch.native import ctc_beam_search_native

        return ctc_beam_search_native(log_probs, beam_width, blank)
    t_len, _ = log_probs.shape
    # beams: prefix tuple -> (log p ending in blank, log p ending in non-blank)
    NEG = -np.inf
    beams = {(): (0.0, NEG)}

    def logsumexp(*xs):
        xs = [x for x in xs if x != NEG]
        if not xs:
            return NEG
        m = max(xs)
        return m + np.log(sum(np.exp(x - m) for x in xs))

    for t in range(t_len):
        lp = log_probs[t]
        top = np.argsort(lp)[::-1][: max(beam_width, 8)]
        new_beams: dict = {}
        for prefix, (pb, pnb) in beams.items():
            for c in top:
                c = int(c)
                p = float(lp[c])
                if c == blank:
                    nb = new_beams.setdefault(prefix, (NEG, NEG))
                    new_beams[prefix] = (logsumexp(nb[0], pb + p, pnb + p), nb[1])
                elif prefix and c == prefix[-1]:
                    # repeat: extends non-blank path as same prefix, or new
                    # prefix via the blank path
                    nb = new_beams.setdefault(prefix, (NEG, NEG))
                    new_beams[prefix] = (nb[0], logsumexp(nb[1], pnb + p))
                    ext = prefix + (c,)
                    nb2 = new_beams.setdefault(ext, (NEG, NEG))
                    new_beams[ext] = (nb2[0], logsumexp(nb2[1], pb + p))
                else:
                    ext = prefix + (c,)
                    nb2 = new_beams.setdefault(ext, (NEG, NEG))
                    new_beams[ext] = (nb2[0], logsumexp(nb2[1], pb + p, pnb + p))
        # prune
        scored = sorted(new_beams.items(),
                        key=lambda kv: logsumexp(*kv[1]), reverse=True)
        beams = dict(scored[:beam_width])

    best_prefix, (pb, pnb) = max(beams.items(), key=lambda kv: logsumexp(*kv[1]))
    return list(best_prefix), logsumexp(pb, pnb)
