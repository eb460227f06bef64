"""Unit decoding (JAX reference: decode/units.py).

The reference's beam search scores each step straight from the encoder
logits, so its top-1 hypothesis is the per-step argmax over the non-special
tokens."""

from __future__ import annotations

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
