"""Batched beam search for seq2seq decoding (JAX reference: decode/beam.py;
the fairseq SequenceGenerator of reference avhubert/sequence_generator.py).

A loop over max_len steps on device tensors, with no host sync inside:
length-normalised scores (len_penalty power), finished beams frozen on EOS
at score 0, top-k over beam x vocabulary, pad/unk (and bos when it is not
eos) banned, repeat-n-gram blocking (ban any token that would complete an
n-gram already in the hypothesis) and prefix-token forcing (the first P
steps take the given tokens at the model's own log-prob).

Ties are common: a row at NEG absorbs any log-prob in f32, so every
candidate of a dead beam scores exactly NEG. jax.lax.top_k and jnp.argsort
take the lower index first on ties; `top_k` here is a stable descending
sort, which does the same on every device.

`rescore` is the search's step function with the history forced: the
per-step log-probs that the search gives a set of hypotheses, from one
scorer call over all positions.
"""

from __future__ import annotations

from typing import Callable

import torch

NEG = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Values and indices of the k largest along the last dim, the lower
    index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def at_step(prefix_logits: Callable) -> Callable:
    """A scorer of every position (tokens (N, L) -> (N, L, V)) as the search's
    score_prefix: (tokens (N, max_len + 1), step) -> (N, V), scoring only the
    first step + 1 tokens (the causal mask makes the logits at step the same
    as over the padded prefix)."""
    return lambda tokens, step: prefix_logits(tokens[:, : step + 1])[:, -1]


def step_lprobs(logits, tokens, step: int, finished, *, max_len: int, bos: int, eos: int,
                pad: int, unk: int, no_repeat_ngram_size: int = 0, forced=None):
    """(N, V) logits at `step` -> the log-probs the search ranks: specials
    banned, repeated n-grams blocked, the prefix forced, finished rows
    frozen on EOS. tokens (N, max_len + 1) hold the history up to step;
    forced (N, P) the prefix tokens or None."""
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    n, v = lprobs.shape
    lprobs[:, [pad, unk] + ([bos] if bos != eos else [])] = NEG
    nsz = no_repeat_ngram_size
    n_win = max_len + 2 - nsz
    if nsz > 1 and n_win > 0 and step >= nsz - 1:
        # windows tokens[s : s + nsz - 1] whose next token lies at or before
        # step; the suffix is the last nsz - 1 tokens
        win = torch.stack([tokens[:, t: t + n_win] for t in range(nsz - 1)], dim=-1)
        st = min(max(step - nsz + 2, 0), max_len + 2 - nsz)
        suffix = tokens[:, st: st + nsz - 1]
        gate = torch.arange(n_win, device=tokens.device) + nsz - 1 <= step
        hits = (win == suffix[:, None, :]).all(dim=-1) & gate[None, :]
        nxt = tokens[:, nsz - 1: nsz - 1 + n_win]
        ban = torch.zeros(n, v, dtype=torch.int32, device=lprobs.device).scatter_reduce(
            1, nxt, hits.to(torch.int32), "amax")
        lprobs = torch.where(ban > 0, NEG, lprobs)
    if forced is not None and step < forced.shape[1]:
        tok = forced[:, step: step + 1]
        lprobs = torch.full_like(lprobs, NEG).scatter(1, tok, lprobs.gather(1, tok))
    frozen = torch.full((v,), NEG, device=lprobs.device)
    frozen[eos] = 0.0
    return torch.where(finished[:, None], frozen, lprobs)


def length_normalised(scores, tokens, max_len: int, eos: int, len_penalty: float):
    """scores / length ** len_penalty, the length counting the tokens up to
    and including the first EOS (max_len without one)."""
    is_eos = tokens[:, 1:] == eos
    first_eos = is_eos.to(torch.int32).argmax(dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos + 1, max_len).float()
    return scores / torch.pow(lengths, len_penalty)


def sort_beams(final, tokens, batch_size: int, beam: int):
    """Best first within each batch row (ties: the lower beam first)."""
    final = final.reshape(batch_size, beam)
    tokens = tokens.reshape(batch_size, beam, -1)
    order = torch.sort(-final, dim=1, stable=True).indices
    return (torch.gather(tokens, 1, order[..., None].expand_as(tokens)),
            torch.gather(final, 1, order))


def initial_beams(batch_size: int, beam: int, max_len: int, bos: int, pad: int, device):
    """tokens (N, max_len + 1) of bos then pad, scores (N,) 0 for the first
    beam of each row and NEG for the others, finished (N,) False."""
    n = batch_size * beam
    tokens = torch.full((n, max_len + 1), pad, dtype=torch.int64, device=device)
    tokens[:, 0] = bos
    scores = torch.tensor([0.0] + [NEG] * (beam - 1), device=device).repeat(batch_size)
    return tokens, scores, torch.zeros(n, dtype=torch.bool, device=device)


def select(cand, tokens, finished, step: int, batch_size: int, beam: int, eos: int):
    """Top `beam` of the (N, V) candidate totals of each batch row -> the
    new (tokens, scores, finished) and each new beam's source row."""
    v = cand.shape[1]
    top_scores, top_idx = top_k(cand.reshape(batch_size, beam * v), beam)
    tok = (top_idx % v).reshape(-1)
    src = (torch.arange(batch_size, device=cand.device)[:, None] * beam
           + top_idx // v).reshape(-1)
    tokens = tokens[src]
    tokens[:, step + 1] = tok
    return tokens, top_scores.reshape(-1), finished[src] | (tok == eos), src


def beam_search(score_prefix: Callable, batch_size: int, beam: int, max_len: int, bos: int = 0,
                eos: int = 2, pad: int = 1, unk: int = 3, len_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0, prefix_tokens: torch.Tensor | None = None,
                device=None):
    """score_prefix: (tokens (N, max_len + 1), step) -> (N, V) logits at
    step, N = batch_size x beam. Returns (tokens (B, beam, max_len + 1),
    scores (B, beam)) sorted best-first, on `device` (None: the CPU)."""
    tokens, scores, finished = initial_beams(batch_size, beam, max_len, bos, pad, device)
    forced = (None if prefix_tokens is None
              else prefix_tokens.to(tokens).repeat_interleave(beam, dim=0))
    for step in range(max_len):
        lprobs = step_lprobs(score_prefix(tokens, step), tokens, step, finished,
                             max_len=max_len, bos=bos, eos=eos, pad=pad, unk=unk,
                             no_repeat_ngram_size=no_repeat_ngram_size, forced=forced)
        tokens, scores, finished, _ = select(scores[:, None] + lprobs, tokens, finished, step,
                                             batch_size, beam, eos)
    final = length_normalised(scores, tokens, max_len, eos, len_penalty)
    return sort_beams(final, tokens, batch_size, beam)


def rescore(prefix_logits: Callable, tokens: torch.Tensor, max_len: int, bos: int = 0,
            eos: int = 2, pad: int = 1, unk: int = 3, len_penalty: float = 1.0,
            no_repeat_ngram_size: int = 0, forced: torch.Tensor | None = None):
    """Teacher forcing of hypotheses tokens (N, max_len + 1) (bos first, EOS
    repeated after the first): per-step log-probs (N, max_len) of the tokens
    under beam_search's step function, and their length-normalised total
    (N,), which equals the search's score of a hypothesis it found.
    prefix_logits scores every position at once (tokens (N, L) -> (N, L,
    V)); forced (N, P) are the prefix tokens, repeated per beam."""
    logits = prefix_logits(tokens[:, :max_len])
    finished = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    per_step = []
    for step in range(max_len):
        lp = step_lprobs(logits[:, step], tokens, step, finished, max_len=max_len, bos=bos,
                         eos=eos, pad=pad, unk=unk, no_repeat_ngram_size=no_repeat_ngram_size,
                         forced=forced)
        chosen = tokens[:, step + 1: step + 2]
        per_step.append(lp.gather(1, chosen)[:, 0])
        finished = finished | (chosen[:, 0] == eos)
    per_step = torch.stack(per_step, dim=1)
    return per_step, length_normalised(per_step.sum(dim=1), tokens, max_len, eos, len_penalty)


def strip_sequence(row, bos: int = 0, eos: int = 2) -> list[int]:
    """Drop BOS and everything from the first EOS on."""
    out = []
    for t in row[1:]:
        t = int(t)
        if t == eos:
            break
        out.append(t)
    return out


def hypothesis_tokens(nbest: list[list[list[int]]], max_len: int, bos: int, eos: int,
                      device=None) -> torch.Tensor:
    """n-best lists (stripped) -> the search's (B x beam, max_len + 1) rows:
    bos, the hypothesis, then EOS to the end."""
    rows = [[bos] + h + [eos] * (max_len - len(h)) for hyps in nbest for h in hyps]
    return torch.tensor(rows, dtype=torch.int64, device=device)
