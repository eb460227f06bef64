"""RAVEn fine-tuned lipreading ASR: frontend + encoder + CTC head + decoder
(JAX reference: models/raven_asr.py; the reference's raven/ fine-tune and
eval model): the swish ResNet3D, the conformer with the RAVEn flags
(layerscale, BatchNorm FFN pre-norms, no macaron, no conv module), a CTC
projection and the shared transformer decoder, decoded by the hybrid
CTC/attention beam (decode/ctc_joint.py) with optional LM shallow fusion.

On the card the conformer's 24 layers launch the rel-position attention
kernel once each; the decoder and the search are plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from lip2speech_tpu_torch.decode.beam import at_step, hypothesis_tokens, strip_sequence
from lip2speech_tpu_torch.decode.ctc_joint import joint_beam_search, joint_rescore
from lip2speech_tpu_torch.models.conformer import ConformerEncoder
from lip2speech_tpu_torch.models.layers import Linear
from lip2speech_tpu_torch.models.resnet3d import ResNet3DFrontend
from lip2speech_tpu_torch.models.transformer_decoder import TransformerDecoder


@dataclass
class RavenASRConfig:
    """espnet token layout: model id 0 = <blank>, ids 1..vocab_size-2 are
    the text processor's tokens shifted by +1, id vocab_size-1 = <sos/eos>.
    RavenASR.from_num_classes(nc) builds the config for an nc-token
    processor; to_text_ids undoes the shift."""

    vocab_size: int = 1000
    dim: int = 768
    heads: int = 12
    ffn_dim: int = 3072
    layers: int = 12
    decoder_layers: int = 6
    decoder_heads: int = 4
    blank: int = 0
    # espnet has no pad/unk at the model level: blank fills the token buffer
    # and is the one banned label
    unk: int = 0
    pad: int = 0

    @property
    def bos(self) -> int:
        return self.vocab_size - 1

    @property
    def eos(self) -> int:
        return self.vocab_size - 1


class RavenEncoderCTC(nn.Module):
    """video (B, T, H, W, 1), frames_mask (B, T) -> (encoder states (B, T,
    dim), CTC log-probs (B, T, V))."""

    def __init__(self, cfg: RavenASRConfig):
        super().__init__()
        self.frontend = ResNet3DFrontend(relu_type="swish")
        self.encoder = ConformerEncoder(512, cfg.dim, cfg.ffn_dim, cfg.heads, cfg.layers,
                                        macaron=False, use_conv=False, layerscale=True,
                                        ff_bn_pre=True, drop_path=0.1)
        self.ctc_proj = Linear(cfg.dim, cfg.vocab_size)

    def forward(self, video, frames_mask):
        enc = self.encoder(self.frontend(video), frames_mask)
        return enc, torch.log_softmax(self.ctc_proj(enc), dim=-1)


class RavenASR(nn.Module):
    """encoder (RavenEncoderCTC) + decoder (TransformerDecoder); state_dict
    keys encoder.* and decoder.*, the JAX variables' two trees."""

    def __init__(self, cfg: RavenASRConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = RavenEncoderCTC(cfg)
        self.decoder = TransformerDecoder(vocab_size=cfg.vocab_size, dim=cfg.dim,
                                          heads=cfg.decoder_heads, ffn_dim=cfg.ffn_dim,
                                          layers=cfg.decoder_layers)

    @staticmethod
    def from_num_classes(num_classes: int, **kw) -> RavenASRConfig:
        """Config for a num_classes-token text processor (+blank, +eos)."""
        return RavenASRConfig(vocab_size=num_classes + 2, **kw)

    def to_text_ids(self, hyp: list[int]) -> list[int]:
        """Model-space hypothesis -> text-processor ids (the -1 shift,
        specials dropped)."""
        return [t - 1 for t in hyp if 1 <= t <= self.cfg.vocab_size - 2]

    def _scorers(self, enc, frames_mask, beam: int, lm, lm_weight: float):
        enc_rep = enc.repeat_interleave(beam, dim=0)
        mask_rep = frames_mask.repeat_interleave(beam, dim=0)
        att = lambda tokens: self.decoder(tokens, enc_rep, mask_rep)  # noqa: E731
        return att, (lm if lm is not None and lm_weight else None)

    def _options(self, ctc_weight, lm_weight, len_penalty) -> dict:
        c = self.cfg
        return dict(ctc_weight=ctc_weight, lm_weight=lm_weight, bos=c.bos, eos=c.eos, pad=c.pad,
                    unk=c.unk, blank=c.blank, len_penalty=len_penalty)

    def decode_joint(self, video, frames_mask, beam: int = 10, max_len: int = 50,
                     ctc_weight: float = 0.1, lm=None, lm_weight: float = 0.0,
                     pre_beam: int = 0, len_penalty: float = 0.0):
        """Hybrid CTC/attention beam decode -> (n-best token lists best-first
        per batch row, scores (B, beam) numpy)."""
        cfg = self.cfg
        enc, ctc_logp = self.encoder(video, frames_mask)
        att, lm = self._scorers(enc, frames_mask, beam, lm, lm_weight)
        tokens, scores = joint_beam_search(
            at_step(att), ctc_logp, frames_mask.sum(dim=1), batch_size=enc.shape[0], beam=beam,
            max_len=max_len, lm_score_prefix=None if lm is None else at_step(lm),
            pre_beam=pre_beam, **self._options(ctc_weight, lm_weight, len_penalty))
        tokens = tokens.cpu().numpy()
        return ([[strip_sequence(row, cfg.bos, cfg.eos) for row in rows] for rows in tokens],
                scores.cpu().numpy())

    def decode_beam(self, video, frames_mask, **kw):
        """Attention-only decoding (the joint search at CTC weight 0)."""
        return self.decode_joint(video, frames_mask, ctc_weight=0.0, **kw)

    def rescore_joint(self, video, frames_mask, nbest, max_len: int = 50,
                      ctc_weight: float = 0.1, lm=None, lm_weight: float = 0.0,
                      len_penalty: float = 0.0, encoded=None):
        """Teacher forcing of n-best lists (as decode_joint returns them):
        per-step scores (B, beam, max_len) and totals (B, beam), which equal
        decode_joint's for the hypotheses it found. encoded: the encoder's
        (states, CTC log-probs), when already computed."""
        cfg = self.cfg
        beam = len(nbest[0])
        enc, ctc_logp = self.encoder(video, frames_mask) if encoded is None else encoded
        att, lm = self._scorers(enc, frames_mask, beam, lm, lm_weight)
        tokens = hypothesis_tokens(nbest, max_len, cfg.bos, cfg.eos, enc.device)
        prefix = tokens[:, :max_len]
        per_step, final = joint_rescore(
            att(prefix), None if lm is None else lm(prefix), ctc_logp, frames_mask.sum(dim=1),
            tokens, beam, max_len, **self._options(ctc_weight, lm_weight, len_penalty))
        b = len(nbest)
        return per_step.reshape(b, beam, max_len), final.reshape(b, beam)
