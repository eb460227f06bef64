"""In-tree sentencepiece-unigram training, no sentencepiece package (the
port's own copy of the JAX package's data/spm_train.py; pure Python).

Rebuild of the reference's subword vocabulary generation
(avhubert/preparation/gen_subword.py:31-76, which shells out to
sentencepiece.SentencePieceTrainer): given a transcript corpus, learn a
unigram language model over subword pieces with the standard
seed-substrings -> EM -> prune loop (Kudo 2018), and export a `.vocab`
file in the exact layout the bundled lrs2lrs3_lower.vocab uses
(multi_target_lip2speech/data/: ids 0-3 = <pad>/<sos>/<eos>/<unk>, then
pieces sorted by score) so data/text.py's UnigramTokenizer consumes it
directly.

Pure-host Python: vocabulary training is a one-off prep step, not a
device workload. The same corpus gives the JAX module's pieces, scores and
.vocab bytes.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from pathlib import Path

from lip2speech_tpu_torch.data.text import WORD_BOUNDARY, UnigramTokenizer

SPECIALS = ["<pad>", "<sos>", "<eos>", "<unk>"]
NEG = -1e30


def _logsumexp2(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= NEG / 2:
        return a
    return a + math.log1p(math.exp(b - a))


def _word_counts(lines) -> Counter:
    """Normalized words (with leading word-boundary marker) -> count."""
    words: Counter = Counter()
    for line in lines:
        s = UnigramTokenizer._normalize(line)
        for w in s.split(WORD_BOUNDARY):
            if w:
                words[WORD_BOUNDARY + w] += 1
    return words


def _seed_pieces(words: Counter, seed_size: int, max_piece_len: int) -> dict:
    """Candidate pieces: frequent substrings scored by count*len; the
    word-boundary marker may only appear as a prefix (spm convention)."""
    subs: Counter = Counter()
    for w, c in words.items():
        n = len(w)
        for i in range(n):
            if i > 0 and w[i] == WORD_BOUNDARY:
                continue
            for j in range(i + 1, min(n, i + max_piece_len) + 1):
                subs[w[i:j]] += c
    chars = {p for p in subs if len(p) == 1}
    multi = sorted((p for p in subs if len(p) > 1),
                   key=lambda p: -subs[p] * len(p))[: seed_size - len(chars)]
    total = sum(subs[p] for p in chars) + sum(subs[p] for p in multi)
    return {p: math.log(subs[p] / total) for p in [*chars, *multi]}


def _em_step(words: Counter, model: dict, max_piece_len: int) -> tuple[dict, float]:
    """One EM iteration: expected counts via forward-backward, then
    maximum-likelihood re-estimation. Returns (new model, corpus log-lik)."""
    counts: defaultdict = defaultdict(float)
    loglik = 0.0
    for w, c in words.items():
        n = len(w)
        # lattice edges: (start, end, piece, logp)
        alpha = [NEG] * (n + 1)
        alpha[0] = 0.0
        edges = []
        for i in range(n):
            for j in range(i + 1, min(n, i + max_piece_len) + 1):
                lp = model.get(w[i:j])
                if lp is not None:
                    edges.append((i, j, w[i:j], lp))
        for i, j, p, lp in edges:
            if alpha[i] > NEG / 2:
                alpha[j] = _logsumexp2(alpha[j], alpha[i] + lp)
        if alpha[n] <= NEG / 2:      # unsegmentable (shouldn't happen: chars kept)
            continue
        beta = [NEG] * (n + 1)
        beta[n] = 0.0
        for i, j, p, lp in reversed(edges):
            if beta[j] > NEG / 2:
                beta[i] = _logsumexp2(beta[i], beta[j] + lp)
        z = alpha[n]
        loglik += c * z
        for i, j, p, lp in edges:
            if alpha[i] > NEG / 2 and beta[j] > NEG / 2:
                counts[p] += c * math.exp(alpha[i] + lp + beta[j] - z)
    total = sum(counts.values())
    new_model = {p: math.log(max(v, 1e-12) / total) for p, v in counts.items()
                 if v > 1e-9 or len(p) == 1}
    # single chars must survive with a floor probability
    for p in model:
        if len(p) == 1 and p not in new_model:
            new_model[p] = math.log(1e-12)
    return new_model, loglik


def _viterbi_alt(piece: str, model: dict, max_piece_len: int) -> float:
    """Best segmentation score of `piece` using OTHER pieces (for pruning)."""
    n = len(piece)
    best = [NEG] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] <= NEG / 2:
            continue
        for j in range(i + 1, min(n, i + max_piece_len) + 1):
            sub = piece[i:j]
            if sub == piece:
                continue
            lp = model.get(sub)
            if lp is not None and best[i] + lp > best[j]:
                best[j] = best[i] + lp
    return best[n]


def train_unigram(lines, vocab_size: int = 1000, max_piece_len: int = 8,
                  seed_factor: int = 8, shrink: float = 0.75,
                  em_iters: int = 2) -> list[tuple[str, float]]:
    """Learn a unigram piece model; returns [(piece, logprob)] sorted
    best-first, WITHOUT the 4 specials (write_vocab prepends them)."""
    words = _word_counts(lines)
    if not words:
        return []
    model = _seed_pieces(words, vocab_size * seed_factor, max_piece_len)
    target = max(vocab_size - len(SPECIALS), 1)
    while True:
        for _ in range(em_iters):
            model, _ = _em_step(words, model, max_piece_len)
        if len(model) <= target:
            break
        # prune: drop pieces whose removal costs the least likelihood
        # (expected count * (own score - best alternative segmentation))
        m2, _ = _em_step(words, model, max_piece_len)  # fresh expected probs
        importance = {}
        for p, lp in model.items():
            if len(p) == 1:
                importance[p] = math.inf          # chars are never pruned
                continue
            alt = _viterbi_alt(p, model, max_piece_len)
            importance[p] = (math.exp(m2.get(p, math.log(1e-12)))) * (lp - alt)
        keep = max(target, int(len(model) * shrink))
        kept = sorted(model, key=lambda p: -importance[p])[:keep]
        model = {p: model[p] for p in kept}
    # renormalize and sort by score (specials excluded)
    z = _logsumexp_all(model.values())
    out = [(p, lp - z) for p, lp in model.items()]
    out.sort(key=lambda kv: -kv[1])
    return out[:target]


def _logsumexp_all(vals) -> float:
    vals = list(vals)
    m = max(vals)
    return m + math.log(sum(math.exp(v - m) for v in vals))


def write_vocab(path: str | Path, pieces: list[tuple[str, float]]) -> None:
    """Export in the bundled lrs2lrs3_lower.vocab layout: 4 specials at
    score 0, then pieces best-first, tab-separated."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for s in SPECIALS:
            f.write(f"{s}\t0\n")
        for p, lp in pieces:
            f.write(f"{p}\t{lp:.6g}\n")
