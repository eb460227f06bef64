"""Joint CTC/attention beam search (JAX reference: decode/ctc_joint.py; the
espnet CTC prefix scorer of the RAVEn eval harness, reference
raven/_espnet/nets/ctc_prefix_score.py:273-359, scorers/ctc.py and
beam_search.py:258-308, Watanabe et al. "Hybrid CTC/Attention" Algorithm 2).

A label-synchronous beam like decode/beam.py whose state also holds each
hypothesis's CTC forward variables r (N, T, 2) and prefix log-probability
psi (N,). Each step scores the pre-beam's k best candidates by the non-CTC
score with the CTC prefix score, everything else masked to NEG, and
combines (1 - w) att + w (psi(h.c) - psi(h)) + lm_w lm.

The forward recursion runs sequentially over the frames, a few small
launches a frame and step (about T x max_len x 4 a decode). The JAX
package's associative-scan schedule of the same recursion
(`_ctc_recursion_parallel`, chosen on a TPU) has no counterpart here; psi,
which has no recursion, is one log-sum-exp over the frames.

LOGZERO and NEG stay finite: with -inf, psi - psi_prev turns into NaN.
"""

from __future__ import annotations

from typing import Callable

import torch

from lip2speech_tpu_torch.decode.beam import (initial_beams, length_normalised, select,
                                              sort_beams, top_k)

NEG = -1e30          # beam-level "never select"
LOGZERO = -1e10      # CTC log(0) (reference ctc_prefix_score.py:284)


def mask_ctc_logprobs(logp: torch.Tensor, lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Padded frames emit blank with probability 1 (lp 0) and nothing else
    (LOGZERO), so the recursion carries prefix mass through them unchanged
    (reference CTCPrefixScoreTH.extend_prob, ctc_prefix_score.py:235-236)."""
    t = logp.shape[1]
    valid = torch.arange(t, device=logp.device)[None, :] < lengths[:, None]
    pad_row = torch.full((logp.shape[-1],), LOGZERO, device=logp.device, dtype=logp.dtype)
    pad_row[blank] = 0.0
    return torch.where(valid[:, :, None], logp, pad_row)


def ctc_initial_state(logp: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """r0 (B, T, 2) of the empty prefix: r^n = log 0, r^b = cumulative blank
    log-probs (reference CTCPrefixScore.initial_state, :290-302)."""
    r_b = torch.cumsum(logp[:, :, blank], dim=1)
    return torch.stack([torch.full_like(r_b, LOGZERO), r_b], dim=-1)


def ctc_extend_scores(logp, r_prev, last, out_len: int, cand, blank: int, eos: int):
    """The prefix log-prob of each hypothesis extended by each candidate.

    logp (N, T, V) masked CTC log-probs; r_prev (N, T, 2) the prefixes'
    forward variables; last (N,) their last labels; out_len the number of
    labels they hold; cand (N, K) candidate labels. Returns psi (N, K) and
    the extensions' forward variables r_new (N, K, T, 2) (reference
    CTCPrefixScore.__call__, :304-359)."""
    n, t, _ = logp.shape
    k = cand.shape[1]
    xs = torch.gather(logp, 2, cand[:, None, :].expand(n, t, k))          # (N, T, K)
    blank_lp = logp[:, :, blank]
    r_sum = torch.logaddexp(r_prev[..., 0], r_prev[..., 1])                # (N, T)
    # phi_t(c): the prefix mass at t that an extension by c may take (only
    # the blank-ending part when c repeats the last label)
    is_last = (cand == last[:, None]) & (out_len > 0)
    phi = torch.where(is_last[:, None, :], r_prev[..., 1:2], r_sum[..., None])
    r_n = torch.empty(t, n, k, device=logp.device, dtype=logp.dtype)
    r_b = torch.full((t, n, k), LOGZERO, device=logp.device, dtype=logp.dtype)
    if out_len == 0:
        r_n[0] = xs[:, 0]
    else:
        r_n[0] = LOGZERO
    phi_t, xs_t, blank_t = phi.transpose(0, 1), xs.transpose(0, 1), blank_lp.T[..., None]
    # before frame out_len - 1 the prefix has no mass, so the recursion stays
    # at LOGZERO there: a uniform loop from t = 1 equals the reference's
    # start = max(l, 1)
    for i in range(1, t):
        torch.logaddexp(r_n[i - 1], phi_t[i - 1], out=r_n[i])
        r_n[i] += xs_t[i]
        torch.logaddexp(r_n[i - 1], r_b[i - 1], out=r_b[i])
        r_b[i] += blank_t[i]
    psi = torch.logaddexp(r_n[0], torch.logsumexp(phi[:, :-1] + xs[:, 1:], dim=1))
    r_new = torch.stack([r_n, r_b], dim=-1).permute(1, 2, 0, 3)           # (N, K, T, 2)
    # c == eos: the prefix ends here, the full-sequence probability of the
    # prefix itself (:348-350); padded frames carry r_sum to T - 1
    psi = torch.where(cand == eos, r_sum[:, -1:], psi)
    # blank is not a label (:353-355)
    return torch.where(cand == blank, LOGZERO, psi), r_new


def _banned(bos, eos, pad, unk, blank) -> list[int]:
    return sorted({pad, unk, blank} | ({bos} if bos != eos else set()))


def _base(att_logits, lm_logits, ctc_weight, lm_weight, length_bonus, banned):
    """(N, V) non-CTC score of each label: the weighted attention (and LM)
    log-probs, the length bonus, the specials at NEG."""
    base = (1.0 - ctc_weight) * torch.log_softmax(att_logits.float(), dim=-1)
    if lm_logits is not None:
        base = base + lm_weight * torch.log_softmax(lm_logits.float(), dim=-1)
    if length_bonus:
        base = base + length_bonus          # espnet LengthBonus: + weight per token
    base[:, banned] = NEG
    return base


def joint_beam_search(att_score_prefix: Callable, ctc_logprobs: torch.Tensor,
                      ctc_lengths: torch.Tensor, batch_size: int, beam: int, max_len: int,
                      ctc_weight: float = 0.3, lm_score_prefix: Callable | None = None,
                      lm_weight: float = 0.0, bos: int = 0, eos: int = 2, pad: int = 1,
                      unk: int = 3, blank: int = 0, pre_beam: int = 0, len_penalty: float = 0.0,
                      length_bonus: float = 0.0):
    """Hybrid CTC/attention beam -> (tokens (B, beam, max_len + 1), scores
    (B, beam)) best-first, on the device of ctc_logprobs.

    att_score_prefix / lm_score_prefix: (tokens (N, max_len + 1), step) ->
    (N, V) logits at step; ctc_logprobs (B, T, V) log-softmaxed CTC head
    output; ctc_lengths (B,) valid frames. CTC scores only the pre_beam best
    candidates by the non-CTC score (0: int(1.5 x beam)), every other label
    is masked to NEG (reference beam_search.py:277-286 and :199-207)."""
    dev = ctc_logprobs.device
    n = batch_size * beam
    v = ctc_logprobs.shape[-1]
    k = min(v, pre_beam if pre_beam > 0 else int(1.5 * beam))
    banned = _banned(bos, eos, pad, unk, blank)
    use_lm = lm_score_prefix is not None and lm_weight != 0.0

    logp = mask_ctc_logprobs(ctc_logprobs, ctc_lengths, blank).repeat_interleave(beam, dim=0)
    r_prev = ctc_initial_state(logp, blank)                               # (N, T, 2)
    psi_prev = torch.zeros(n, device=dev)
    tokens, scores, finished = initial_beams(batch_size, beam, max_len, bos, pad, dev)
    frozen = torch.full((v,), NEG, device=dev)
    frozen[eos] = 0.0
    for step in range(max_len):
        base = _base(att_score_prefix(tokens, step),
                     lm_score_prefix(tokens, step) if use_lm else None,
                     ctc_weight, lm_weight, length_bonus, banned)
        cand_base, cand = top_k(base, k)                                  # (N, K)
        psi, r_new = ctc_extend_scores(logp, r_prev, tokens[:, step], step, cand, blank, eos)
        total = cand_base + ctc_weight * (psi - psi_prev[:, None])
        weighted = torch.full((n, v), NEG, device=dev).scatter(1, cand, total)
        weighted = torch.where(finished[:, None], frozen, weighted)
        was_finished = finished
        tokens, scores, finished, src = select(scores[:, None] + weighted, tokens, finished, step,
                                               batch_size, beam, eos)
        # the chosen extension's CTC state: the token's candidate slot (present
        # unless the row was frozen, where the state no longer matters)
        slot = (cand[src] == tokens[:, step + 1, None]).to(torch.int32).argmax(dim=1)
        keep = was_finished[src]
        r_prev = torch.where(keep[:, None, None], r_prev[src], r_new[src, slot])
        psi_prev = torch.where(keep, psi_prev[src], psi[src, slot])
    final = (length_normalised(scores, tokens, max_len, eos, len_penalty) if len_penalty
             else scores)
    return sort_beams(final, tokens, batch_size, beam)


def joint_rescore(att_logits: torch.Tensor, lm_logits: torch.Tensor | None,
                  ctc_logprobs: torch.Tensor, ctc_lengths: torch.Tensor, tokens: torch.Tensor,
                  beam: int, max_len: int, ctc_weight: float = 0.3, lm_weight: float = 0.0,
                  bos: int = 0, eos: int = 2, pad: int = 1, unk: int = 3, blank: int = 0,
                  len_penalty: float = 0.0, length_bonus: float = 0.0):
    """Teacher forcing of hypotheses tokens (N, max_len + 1), N = B x beam:
    the per-step scores (N, max_len) the joint search gives them and their
    total (N,). att_logits / lm_logits (N, max_len, V) score every position
    at once. The pre-beam is not applied: a token the search took was in
    its candidates."""
    dev = ctc_logprobs.device
    n = tokens.shape[0]
    banned = _banned(bos, eos, pad, unk, blank)
    logp = mask_ctc_logprobs(ctc_logprobs, ctc_lengths, blank).repeat_interleave(beam, dim=0)
    r_prev = ctc_initial_state(logp, blank)
    psi_prev = torch.zeros(n, device=dev)
    finished = torch.zeros(n, dtype=torch.bool, device=dev)
    per_step = []
    for step in range(max_len):
        base = _base(att_logits[:, step], None if lm_logits is None else lm_logits[:, step],
                     ctc_weight, lm_weight, length_bonus, banned)
        chosen = tokens[:, step + 1: step + 2]
        psi, r_new = ctc_extend_scores(logp, r_prev, tokens[:, step], step, chosen, blank, eos)
        got = base.gather(1, chosen)[:, 0] + ctc_weight * (psi[:, 0] - psi_prev)
        per_step.append(torch.where(finished, torch.where(chosen[:, 0] == eos, 0.0, NEG), got))
        r_prev = torch.where(finished[:, None, None], r_prev, r_new[:, 0])
        psi_prev = torch.where(finished, psi_prev, psi[:, 0])
        finished = finished | (chosen[:, 0] == eos)
    per_step = torch.stack(per_step, dim=1)
    total = per_step.sum(dim=1)
    final = (length_normalised(total, tokens, max_len, eos, len_penalty) if len_penalty
             else total)
    return per_step, final
