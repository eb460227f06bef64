"""Span mask sampling for masked-prediction pretraining (the port's own copy
of the JAX package's ops/masking.py; numpy, so the same generator state
gives the same mask bit for bit).

fairseq's compute_mask_indices "static" policy as AV-HuBERT's input masking
uses it: ~mask_prob * T / mask_length span starts per row (min_masks
floor), drawn without replacement; overlapping spans merge.
"""

from __future__ import annotations

import numpy as np


def compute_mask_indices(
    shape: tuple[int, int],
    padding_mask: np.ndarray | None,
    mask_prob: float,
    mask_length: int,
    rng: np.random.Generator,
    min_masks: int = 2,
) -> np.ndarray:
    """(B, T) bool span mask; True = masked. Static policy, with overlap.
    padding_mask: None (every frame valid), bool (B, T) with True = pad, or
    any other dtype, whose row sum is the row's number of valid frames.
    Rows shorter than mask_length get no span and draw nothing."""
    b, t = shape
    out = np.zeros((b, t), bool)
    for i in range(b):
        seq_len = t
        if padding_mask is not None:
            seq_len = int((~padding_mask[i]).sum()) if padding_mask.dtype == bool \
                else int(padding_mask[i].sum())
        if seq_len < mask_length:
            continue
        num_mask = int(mask_prob * seq_len / float(mask_length) + rng.random())
        num_mask = max(min_masks, num_mask)
        starts = rng.choice(max(seq_len - mask_length + 1, 1),
                            size=min(num_mask, max(seq_len - mask_length + 1, 1)),
                            replace=False)
        for s in starts:
            out[i, s : s + mask_length] = True
    return out
