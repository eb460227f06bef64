"""Unit decoding (JAX reference: decode/units.py).

The reference's beam search scores each step straight from the encoder
logits, so its top-1 hypothesis is the per-step argmax over the non-special
tokens, and its n-best list is the n smallest total regrets against that
argmax (`beam_units`, exact, enumerated on the host)."""

from __future__ import annotations

import heapq

import numpy as np
import torch


def argmax_units(unit_logits: torch.Tensor, unit_mask: torch.Tensor,
                 num_special: int = 4) -> torch.Tensor:
    """(B, T2, V) logits + (B, T2) validity -> (B, T2) unit ids in
    [0, V - num_special); -1 where the mask is False."""
    units = torch.argmax(unit_logits[..., num_special:], dim=-1)
    return torch.where(unit_mask, units, -1)


def unit_edit_distance(a: list[int], b: list[int]) -> int:
    """Levenshtein distance between two unit sequences (editdistance.eval),
    for the unit WER."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def beam_units(unit_logits: torch.Tensor, unit_mask: torch.Tensor, beam: int,
               num_special: int = 4, return_scores: bool = False):
    """Exact n-best (the reference's beam=50 decode.yaml): with per-step
    scores independent of the beam history a sequence's score is a sum of
    per-step log-probs, and the n-best list is the n smallest total regrets
    against the per-step argmax, enumerated by a best-first heap over swap
    sets (which steps deviate to which alternative rank). Returns (B, beam,
    T2) unit ids (-1 where masked) on the logits' device, and with
    return_scores also the (B, beam) scores (-inf past the hypotheses)."""
    lprobs = torch.log_softmax(unit_logits[..., num_special:].float(), dim=-1).cpu().numpy()
    mask = unit_mask.cpu().numpy()
    b, t, v = lprobs.shape
    k = min(beam, v)
    # per step: candidates sorted best-first, regret[j] = lp[0] - lp[j] >= 0
    order = np.argsort(-lprobs, axis=-1, kind="stable")[..., :k]   # (B, T, k)
    sorted_lp = np.take_along_axis(lprobs, order, axis=-1)
    regret = sorted_lp[..., :1] - sorted_lp

    all_hyps = np.full((b, beam, t), -1, np.int64)
    all_scores = np.full((b, beam), -np.inf)
    for i in range(b):
        valid = np.nonzero(mask[i])[0]
        base_score = float(sorted_lp[i, valid, 0].sum()) if len(valid) else 0.0
        # heap entries: (total regret, swaps), swaps a sorted tuple of
        # (index into valid, alternative rank >= 1)
        heap = [(0.0, ())]
        seen = {()}
        n_out = 0
        while heap and n_out < beam:
            reg, swaps = heapq.heappop(heap)
            seq = order[i, :, 0].copy()
            for p, j in swaps:
                seq[valid[p]] = order[i, valid[p], j]
            all_hyps[i, n_out] = np.where(mask[i], seq, -1)
            all_scores[i, n_out] = base_score - reg
            n_out += 1
            swapped = dict(swaps)
            for p in range(len(valid)):
                j = swapped.get(p, 0)
                if j + 1 < k:
                    nxt = tuple(sorted({**swapped, p: j + 1}.items()))
                    if nxt not in seen:
                        seen.add(nxt)
                        step_reg = regret[i, valid[p], j + 1] - regret[i, valid[p], j]
                        heapq.heappush(heap, (reg + float(step_reg), nxt))
    hyps = torch.from_numpy(all_hyps).to(unit_logits.device)
    if return_scores:
        return hyps, torch.from_numpy(all_scores).to(unit_logits.device)
    return hyps


def units_to_text(units) -> str:
    """One decoded row (-1 padded) in the reference's .unt format."""
    return " ".join(str(int(u)) for u in units if u >= 0)


def dedup_units(units: list[int]) -> list[int]:
    """Collapse consecutive duplicates (for HuBERT-unit workflows that
    dedup; the reference's unit WER compares the raw sequences)."""
    out = []
    for u in units:
        if not out or out[-1] != u:
            out.append(u)
    return out


def unit_wer(hyps: list[list[int]], refs: list[list[int]]) -> float:
    """Corpus unit-level WER = sum(edit) / sum(len(ref)) (reference
    inference.py:299-317), through the native edit distance."""
    from lip2speech_tpu_torch.native import edit_distance

    err = sum(edit_distance(h, r) for h, r in zip(hyps, refs))
    return err / max(sum(len(r) for r in refs), 1)
