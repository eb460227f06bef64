"""Stage-1 multi-target model: video -> unit logits + mel (JAX reference:
models/multi_target.py), with one of four frontends: `resnet3d`, `avhubert`
(AV-HuBERT encoder), `auto_avsr` (ResNet3D + conformer encoder) or `raven`
(ResNet3D + rel-MHA transformer with layerscale and BatchNorm pre-norms).

Frontend features (25 Hz) are repeated 2x in time (50 Hz) and encoded by
the conformer; then
  unit head: dropout -> 3-layer GELU MLP -> vocab logits      (50 Hz)
  mel head : concat(spk, x) -> 3x [conv1d k3 + GELU] -> Linear(d, 160)
             -> 160 = 2 x 80 interleaved in time              (100 Hz)
  text head: Linear(d, text vocab) on the unit head's input, when
             `text_supervision` is set (CTC loss in training)

`module.train()` turns on the recipe's dropout (heads: `final_dropout`) and
BatchNorm batch statistics; the noise draws from the `torch.Generator` given
to `forward`. A frozen frontend always runs in eval mode, without gradient,
and its features enter the conformer detached.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.core.config import MultiTargetConfig
from lip2speech_tpu_torch.models.avhubert import AVHubertEncoder
from lip2speech_tpu_torch.models.conformer import ConformerEncoder
from lip2speech_tpu_torch.models.layers import Conv1d, Linear
from lip2speech_tpu_torch.models.resnet3d import ResNet3DFrontend
from lip2speech_tpu_torch.ops import nn as ops


def interleave_time(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, T, ...) -> (B, factor*T, ...), each step repeated `factor` times."""
    return torch.repeat_interleave(x, factor, dim=1)


class MLPHead(nn.Module):
    def __init__(self, dim: int, out_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.fc0 = Linear(dim, dim, init="kaiming_fan_out")
        self.fc1 = Linear(dim, dim, init="kaiming_fan_out")
        self.last = Linear(dim, out_dim, init="kaiming_fan_out")

    def forward(self, x, gen=None):
        for fc in (self.fc0, self.fc1):
            x = ops.gelu(fc(x))
            if self.training:
                x = ops.dropout(x, self.dropout, gen)
        return self.last(x)


class MelHead(nn.Module):
    def __init__(self, dim: int, spk_dim: int = 256, mel_dim: int = 80, dropout: float = 0.1):
        super().__init__()
        self.mel_dim = mel_dim
        self.dropout = dropout
        self.conv0 = Conv1d(spk_dim + dim, dim, 3, padding=1)
        self.conv1 = Conv1d(dim, dim, 3, padding=1)
        self.conv2 = Conv1d(dim, dim, 3, padding=1)
        self.proj = Linear(dim, 2 * mel_dim)

    def forward(self, x, spk_emb, gen=None):
        """x (B, T, D) at 50 Hz; spk_emb (B, S) -> (B, 2T, mel_dim) at 100 Hz."""
        b, t, _ = x.shape
        spk = spk_emb[:, :, None].expand(b, spk_emb.shape[1], t)
        y = torch.cat([spk, x.transpose(1, 2)], dim=1)
        for conv in (self.conv0, self.conv1, self.conv2):
            y = conv(y)
            if self.training:
                y = ops.dropout(y, self.dropout, gen)
            y = ops.gelu(y)
        y = self.proj(y.transpose(1, 2))                       # (B, T, 160)
        # channel c*2+j of step t is mel bin c of frame 2t+j
        y = y.reshape(b, t, self.mel_dim, 2).transpose(2, 3)
        return y.reshape(b, 2 * t, self.mel_dim)


class MultiTargetModel(nn.Module):
    def __init__(self, cfg: MultiTargetConfig):
        super().__init__()
        cf = cfg.conformer
        self.cfg = cfg
        fe = cfg.frontend
        if fe.kind == "resnet3d":
            self.frontend = ResNet3DFrontend(fe.relu_type)
        elif fe.kind == "avhubert":
            self.frontend = AVHubertEncoder(fe.encoder_dim, fe.encoder_heads,
                                            fe.encoder_ffn_dim, fe.encoder_layers)
        elif fe.kind in ("auto_avsr", "raven"):
            raven = fe.kind == "raven"
            self.frontend_resnet = ResNet3DFrontend("swish")
            self.frontend_encoder = ConformerEncoder(
                512, fe.encoder_dim, fe.encoder_ffn_dim, fe.encoder_heads, fe.encoder_layers,
                macaron=not raven, use_conv=not raven, layerscale=raven, ff_bn_pre=raven,
                drop_path=0.1 if raven else 0.0)
        else:
            raise ValueError(f"unknown frontend {fe.kind!r}")
        self.conformer = ConformerEncoder(cf.input_dim, cf.dim, cf.ffn_dim, cf.heads,
                                          cf.layers, cf.conv_kernel, macaron=cf.macaron,
                                          normalize_before=cf.layer_norm_first,
                                          dropout=cf.dropout,
                                          attention_dropout=cf.attention_dropout,
                                          positional_dropout=cf.dropout)
        self.unit_head = MLPHead(cf.dim, cfg.units.vocab_size, cfg.final_dropout)
        self.mel_head = MelHead(cf.dim, cfg.spk_emb_dim, cfg.mel_dim, cfg.final_dropout)
        if cfg.text_supervision and cfg.text_vocab_size:
            self.text_head = Linear(cf.dim, cfg.text_vocab_size)
        else:
            self.text_head = None

    def frontend_modules(self) -> list[nn.Module]:
        """The submodules whose parameters are the frontend's (names starting
        with `frontend`)."""
        return [m for name, m in self.named_children() if name.startswith("frontend")]

    def train(self, mode: bool = True):
        """A frozen frontend stays in eval mode (running statistics, no
        dropout) whatever the rest of the model is in."""
        super().train(mode)
        if self.cfg.frontend.frozen:
            for m in self.frontend_modules():
                m.eval()
        return self

    def _frontend(self, video, frames_mask, gen, seed_gen) -> torch.Tensor:
        kind = self.cfg.frontend.kind
        if kind == "resnet3d":
            return self.frontend(video)
        if kind == "avhubert":
            return self.frontend(video, frames_mask, gen=gen)
        return self.frontend_encoder(self.frontend_resnet(video), frames_mask, gen, seed_gen)

    def extract_frontend(self, video, frames_mask, gen=None, seed_gen=None) -> torch.Tensor:
        """(B, T, H, W, 1) -> (B, T, F) frontend features at 25 Hz; from a
        frozen frontend without gradient."""
        if self.cfg.frontend.frozen:
            with torch.no_grad():
                return self._frontend(video, frames_mask, gen, seed_gen)
        return self._frontend(video, frames_mask, gen, seed_gen)

    def forward(self, video, frames_mask, spk_emb, gen=None,
                seed_gen=None) -> dict[str, torch.Tensor]:
        """video (B, T, H, W, 1); frames_mask (B, T) bool; spk_emb (B, 256);
        gen: generator of the training-mode noise (None: the default one);
        seed_gen: CPU generator of the attention-dropout seeds (see
        ConformerEncoder.forward).

        Returns unit_logits (B, 2T, vocab), mel (B, 4T, 80), mask (B, 2T) and,
        with a text head, text_logits (B, 2T, text vocab)."""
        feats = self.extract_frontend(video, frames_mask, gen, seed_gen)
        factor = self.cfg.units.units_per_frame
        x = interleave_time(feats, factor)
        mask = interleave_time(frames_mask, factor)
        x = self.conformer(x, mask, gen, seed_gen)
        mel = self.mel_head(x, spk_emb, gen)
        y = ops.dropout(x, self.cfg.final_dropout, gen) if self.training else x
        out = {"unit_logits": self.unit_head(y, gen), "mel": mel, "mask": mask}
        if self.text_head is not None:
            out["text_logits"] = self.text_head(y)
        return out
