"""AV-HuBERT masked-prediction pretraining, audio-visual (JAX reference:
models/avhubert_pretrain.py), the task that produces the AV-HuBERT frontend.

  input masking: masked video frames are zeroed by the caller
    (mask_video_frames); masked audio frames are replaced in the model by
    the learned mask_emb
  video: prelu ResNet3D -> video_proj; audio: audio_proj; an absent
    modality contributes zeros, and in training one draw per forward may
    zero a whole modality (fuse_modality_features)
  concat([audio, video]) -> LayerNorm(2D) -> post_extract_proj -> dropout
  -> wav2vec2 transformer -> final_proj
  logits = cosine(final_proj(x), label_embs) / logit_temp

The module is AVHubertEncoder's trunk with pretraining's head; the
attention of its transformer runs on the attention kernel on the card
(ops/attention.py) unless attention dropout is active in training.
pretrain_loss is the criterion: cross-entropy summed over the masked (and,
weighted, the unmasked) valid frames, computed densely and weighted by the
masks, plus the feature penalty. Pretraining has no trainer in either
package: a loop is value_and_grad of pretrain_loss and an optimizer step.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.models.avhubert import (Wav2Vec2TransformerEncoder,
                                                  fuse_modality_features)
from lip2speech_tpu_torch.models.layers import LayerNorm, Linear
from lip2speech_tpu_torch.models.resnet3d import ResNet3DFrontend
from lip2speech_tpu_torch.ops import nn as ops


class AVHubertPretrainModel(nn.Module):
    """audio_feat_dim > 0 (104: 26 log-filterbank x 4 stacked) builds the
    audio modality: mask_emb and audio_proj, whether or not a call gives
    audio. With audio_feat_dim 0, audio is ignored, as in the JAX module."""

    def __init__(self, dim: int = 1024, heads: int = 16, ffn_dim: int = 4096, layers: int = 24,
                 final_dim: int = 256, num_classes: int = 500, logit_temp: float = 0.1,
                 dropout: float = 0.1, layer_norm_first: bool = True, audio_feat_dim: int = 0,
                 modality_dropout: float = 0.0, audio_dropout: float = 0.0):
        super().__init__()
        self.audio_feat_dim, self.dropout, self.logit_temp = audio_feat_dim, dropout, logit_temp
        self.modality_dropout, self.audio_dropout = modality_dropout, audio_dropout
        self.resnet = ResNet3DFrontend(relu_type="prelu")
        self.video_proj = Linear(512, dim)
        if audio_feat_dim > 0:
            self.mask_emb = nn.Parameter(torch.empty(audio_feat_dim))
            self.audio_proj = Linear(audio_feat_dim, dim)
        self.fuse_layer_norm = LayerNorm(2 * dim, eps=1e-5)
        self.post_extract_proj = Linear(2 * dim, dim)
        self.encoder = Wav2Vec2TransformerEncoder(dim, heads, ffn_dim, layers, layer_norm_first,
                                                  dropout)
        self.final_proj = Linear(dim, final_dim)
        self.label_embs = nn.Parameter(torch.empty(num_classes, final_dim))

    def init_random(self, gen: torch.Generator) -> None:
        """The module's own parameters, uniform in [0, 1) as in the JAX
        module (hubert.py's mask_emb init); the layers fill themselves."""
        with torch.no_grad():
            self.label_embs.uniform_(0.0, 1.0, generator=gen)
            if self.audio_feat_dim > 0:
                self.mask_emb.uniform_(0.0, 1.0, generator=gen)

    def forward(self, video, frames_mask, span_mask, audio=None, gen=None) -> dict:
        """video: (B, T, H, W, 1) with masked frames already zeroed, or None
        (audio only); audio: (B, T, F) raw stacked features, whose masked
        frames are replaced here by mask_emb; frames_mask (B, T) True =
        valid; span_mask (B, T) True = masked. gen: the generator of the
        dropout and modality-dropout draws in training (None: the default).

        Returns {"logits" (B, T, V), "span_mask", "frames_mask", "features_pen"}."""
        feats_v = feats_a = None
        if video is not None:
            feats_v = self.video_proj(self.resnet(video))
        if self.audio_feat_dim > 0 and audio is not None:
            audio = torch.where(span_mask[:, :, None], self.mask_emb.to(audio.dtype), audio)
            feats_a = self.audio_proj(audio)
        if feats_a is None and feats_v is None:
            raise ValueError("need at least one modality")
        feats_a, feats_v = fuse_modality_features(feats_a, feats_v, self.modality_dropout,
                                                  self.audio_dropout, self.training, gen)
        fused = torch.cat([feats_a, feats_v], dim=-1)
        features_pen = fused.square().mean()
        x = self.post_extract_proj(self.fuse_layer_norm(fused))
        if self.training:
            x = ops.dropout(x, self.dropout, gen)
        x = self.encoder(x, frames_mask, gen)
        proj = self.final_proj(x)                                        # (B, T, F)
        pn = proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp(min=1e-6)
        en = self.label_embs / torch.linalg.vector_norm(
            self.label_embs, dim=-1, keepdim=True).clamp(min=1e-6)
        return {"logits": (pn @ en.T) / self.logit_temp, "span_mask": span_mask,
                "frames_mask": frames_mask, "features_pen": features_pen}


def pretrain_loss(outputs: dict, targets: torch.Tensor, pred_masked_weight: float = 1.0,
                  pred_nomask_weight: float = 0.0, feature_pen_weight: float = 10.0):
    """AVHubertCriterion: sum-reduced CE over the masked (and, weighted, the
    unmasked) valid frames + feature_pen_weight x the feature penalty.
    targets (B, T) int. Returns (loss, logs: loss_m, loss_u, n_masked,
    n_correct_m, features_pen), logs as tensors."""
    logits = outputs["logits"]
    lprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lprobs, -1, targets[..., None].long())[..., 0]
    valid = outputs["frames_mask"]
    masked = outputs["span_mask"] & valid
    unmasked = ~outputs["span_mask"] & valid
    loss_m = torch.where(masked, nll, 0.0).sum()
    loss_u = torch.where(unmasked, nll, 0.0).sum()
    loss = (pred_masked_weight * loss_m + pred_nomask_weight * loss_u
            + feature_pen_weight * outputs["features_pen"])
    # argmax takes the first of tied maxima, as jnp.argmax does
    correct_m = ((torch.argmax(logits, -1) == targets) & masked).sum()
    logs = {"loss_m": loss_m, "loss_u": loss_u, "n_masked": masked.sum(),
            "n_correct_m": correct_m, "features_pen": outputs["features_pen"]}
    return loss, logs


def mask_video_frames(video: torch.Tensor, span_mask: torch.Tensor) -> torch.Tensor:
    """Zero the masked frames of (B, T, H, W, C) video (hubert.py's input
    masking)."""
    return torch.where(span_mask[:, :, None, None, None], 0.0, video)
