"""Stage-1 training losses (JAX reference: train/losses.py).

  * label-smoothed cross-entropy on the units, length-matched (logits and
    targets cut to their common length), pad ignored;
  * mel loss = masked L1 (mean over bins, per-sentence mean over frames with
    sentence_avg, summed over the batch) + spectral convergence (ratio of
    Frobenius norms per sample);
  * optional CTC loss on the text head.

All are sum-reduced and mask-based, so padded rows and frames add nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def label_smoothed_ce(logits, targets, pad_id: int, eps: float = 0.1,
                      sentence_avg: bool = True):
    """fairseq label_smoothed_nll_loss with sum reduction. logits (B, T, V);
    targets (B, T') int tokens, pad = pad_id. Returns (loss, nll_loss,
    sample_size): sample_size counts the sentences with at least one valid
    token (or, without sentence_avg, the valid tokens), so all-pad dummy rows
    add nothing to the normaliser."""
    t = min(logits.shape[1], targets.shape[1])
    logits, targets = logits[:, :t], targets[:, :t].long()
    lprobs = F.log_softmax(logits, dim=-1)
    valid = targets != pad_id
    nll = -lprobs.gather(-1, targets[..., None])[..., 0]
    nll_loss = torch.where(valid, nll, 0.0).sum()
    smooth_loss = torch.where(valid, -lprobs.sum(-1), 0.0).sum()
    eps_i = eps / (logits.shape[-1] - 1)
    loss = (1.0 - eps - eps_i) * nll_loss + eps_i * smooth_loss
    sample_size = valid.any(dim=1).sum() if sentence_avg else valid.sum()
    return loss, nll_loss, sample_size


def unit_accuracy(logits, targets, pad_id: int):
    """(correct, valid) token counts over the common length."""
    t = min(logits.shape[1], targets.shape[1])
    logits, targets = logits[:, :t], targets[:, :t]
    valid = targets != pad_id
    correct = (logits.argmax(-1) == targets) & valid
    return correct.sum(), valid.sum()


def mel_loss(pred, target, mel_mask, sentence_avg: bool = True):
    """Masked L1 + spectral convergence. pred (B, T, 80); target (B, T', 80);
    mel_mask (B, T'') bool, True = valid mel frame."""
    t = min(pred.shape[1], target.shape[1], mel_mask.shape[1])
    pred, target = pred[:, :t], target[:, :t]
    maskf = mel_mask[:, :t].to(pred.dtype)
    n_frames = maskf.sum(1)
    l1 = (pred - target).abs().mean(-1) * maskf
    if sentence_avg:
        l1_loss = (l1.sum(1) / n_frames.clamp(min=1.0)).sum()
    else:
        l1_loss = l1.sum()
    diff_sq = ((pred - target).square().sum(-1) * maskf).sum(1)
    targ_sq = (target.square().sum(-1) * maskf).sum(1)
    # a row with no valid frame has diff_sq == 0, where sqrt has no finite
    # slope: it gets value 0 and gradient 0 instead of 0 * inf
    some = diff_sq > 0
    sc = torch.where(some, torch.where(some, diff_sq, 1.0).sqrt(), 0.0)
    sc = sc / targ_sq.sqrt().clamp(min=1e-8)
    sc_loss = sc.sum() if sentence_avg else (sc * n_frames).sum()
    return l1_loss + sc_loss


def ctc_text_loss(logits, logit_mask, labels, label_lengths, blank_id: int = 0):
    """CTC loss of the text head, summed over the batch. logits (B, T, C) at
    50 Hz; logit_mask (B, T) bool with the valid steps first; labels (B, L)
    padded; label_lengths (B,). (The JAX package gives optax.ctc_loss logits
    and paddings; F.ctc_loss takes time-major log-probabilities and lengths.)"""
    lprobs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    return F.ctc_loss(lprobs, labels.long(), logit_mask.sum(1), label_lengths.long(),
                      blank=blank_id, reduction="sum", zero_infinity=False)


def stage1_loss(outputs: dict, batch: dict, pad_id: int, label_smoothing: float = 0.1,
                mel_weight: float = 10.0, text_weight: float = 1.0,
                sentence_avg: bool = True):
    """Total stage-1 loss. batch: unit_tokens (B, Tu), mel (B, Tm, 80),
    frames_mask (B, Tf), optionally text_labels / text_lengths. Returns
    (loss, sample_size, logs)."""
    ce, nll, sample_size = label_smoothed_ce(outputs["unit_logits"], batch["unit_tokens"],
                                             pad_id, label_smoothing, sentence_avg)
    mel_mask = torch.repeat_interleave(batch["frames_mask"], 4, dim=1)
    ml = mel_loss(outputs["mel"], batch["mel"], mel_mask, sentence_avg)
    loss = ce + mel_weight * ml
    logs = {"nll_loss": nll, "mel_loss": ml, "ce_loss": ce}
    if "text_logits" in outputs and "text_labels" in batch:
        ctc = ctc_text_loss(outputs["text_logits"], outputs["mask"], batch["text_labels"],
                            batch["text_lengths"])
        loss = loss + text_weight * ctc
        logs["ctc_loss"] = ctc
    logs["n_correct"], logs["total"] = unit_accuracy(outputs["unit_logits"],
                                                     batch["unit_tokens"], pad_id)
    logs["loss"] = loss
    return loss, sample_size, logs
