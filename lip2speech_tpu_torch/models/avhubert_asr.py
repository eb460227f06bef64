"""AV-HuBERT seq2seq lipreading ASR, the infer_s2s path (JAX reference:
models/avhubert_asr.py; reference avhubert/hubert_asr.py:411-516 and
infer_s2s.py:50-318): the AV-HuBERT video encoder, then the transformer
decoder, then the beam search, then text.

The encoder runs once a call and the beam repeats its output; on the card
its 24 layers launch the masked attention kernel once each. The decoder and
the search are plain PyTorch: the search re-scores each prefix (no KV
cache), as the JAX decoder does.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from lip2speech_tpu_torch.decode.beam import (at_step, beam_search, hypothesis_tokens, rescore,
                                              strip_sequence)
from lip2speech_tpu_torch.models.avhubert import AVHubertEncoder
from lip2speech_tpu_torch.models.lm import fuse_with_lm
from lip2speech_tpu_torch.models.transformer_decoder import TransformerDecoder


@dataclass
class Seq2SeqConfig:
    vocab_size: int = 1000          # sentencepiece unigram vocab
    encoder_dim: int = 1024
    encoder_heads: int = 16
    encoder_ffn_dim: int = 4096
    encoder_layers: int = 24
    decoder_dim: int = 768
    decoder_heads: int = 4
    decoder_ffn_dim: int = 3072
    decoder_layers: int = 6
    bos: int = 0
    pad: int = 1
    eos: int = 2
    unk: int = 3


class AVHubertSeq2Seq(nn.Module):
    """encoder (AVHubertEncoder, video only) + decoder (TransformerDecoder);
    state_dict keys encoder.* and decoder.*, the JAX variables' two trees."""

    def __init__(self, cfg: Seq2SeqConfig):
        super().__init__()
        if cfg.decoder_dim != cfg.encoder_dim:
            # fairseq inserts no projection between the two: the decoder's
            # cross-attention reads the encoder's width
            raise ValueError("decoder_dim must equal encoder_dim in this build")
        self.cfg = cfg
        self.encoder = AVHubertEncoder(dim=cfg.encoder_dim, heads=cfg.encoder_heads,
                                       ffn_dim=cfg.encoder_ffn_dim, layers=cfg.encoder_layers)
        self.decoder = TransformerDecoder(vocab_size=cfg.vocab_size, dim=cfg.decoder_dim,
                                          heads=cfg.decoder_heads, ffn_dim=cfg.decoder_ffn_dim,
                                          layers=cfg.decoder_layers)

    def encode(self, video, frames_mask):
        return self.encoder(video, frames_mask)

    def _prefix_logits(self, enc, frames_mask, beam: int, lm=None, lm_weight: float = 0.0):
        """tokens (B x beam, L) -> (B x beam, L, V) scores at every position:
        the decoder's logits, or with an LM its shallow fusion."""
        enc_rep = enc.repeat_interleave(beam, dim=0)
        mask_rep = frames_mask.repeat_interleave(beam, dim=0)
        fn = lambda tokens: self.decoder(tokens, enc_rep, mask_rep)  # noqa: E731
        if lm is not None and lm_weight:
            fn = fuse_with_lm(fn, lm, lm_weight)
        return fn

    def decode_beam(self, video, frames_mask, beam: int = 10, max_len: int = 50,
                    len_penalty: float = 1.0, no_repeat_ngram_size: int = 0, lm=None,
                    lm_weight: float = 0.0):
        """video (B, T, H, W, 1), frames_mask (B, T) -> (n-best token lists
        best-first per batch row, scores (B, beam) numpy). lm / lm_weight add
        shallow fusion (score = log p_am + lm_weight x log p_lm)."""
        cfg = self.cfg
        enc = self.encode(video, frames_mask)
        score = at_step(self._prefix_logits(enc, frames_mask, beam, lm, lm_weight))
        tokens, scores = beam_search(score, enc.shape[0], beam, max_len, bos=cfg.bos,
                                     eos=cfg.eos, pad=cfg.pad, unk=cfg.unk,
                                     len_penalty=len_penalty,
                                     no_repeat_ngram_size=no_repeat_ngram_size,
                                     device=enc.device)
        tokens = tokens.cpu().numpy()
        return ([[strip_sequence(row, cfg.bos, cfg.eos) for row in rows] for rows in tokens],
                scores.cpu().numpy())

    def rescore(self, video, frames_mask, nbest, max_len: int = 50, len_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0, lm=None, lm_weight: float = 0.0, enc=None):
        """Teacher forcing of n-best lists (as decode_beam returns them) with
        decode_beam's options: per-step log-probs (B, beam, max_len) and
        scores (B, beam), which equal decode_beam's for the hypotheses it
        found. enc: the encoder's output, when already computed."""
        cfg = self.cfg
        beam = len(nbest[0])
        enc = self.encode(video, frames_mask) if enc is None else enc
        tokens = hypothesis_tokens(nbest, max_len, cfg.bos, cfg.eos, enc.device)
        per_step, final = rescore(self._prefix_logits(enc, frames_mask, beam, lm, lm_weight),
                                  tokens, max_len, bos=cfg.bos, eos=cfg.eos, pad=cfg.pad,
                                  unk=cfg.unk, len_penalty=len_penalty,
                                  no_repeat_ngram_size=no_repeat_ngram_size)
        b = len(nbest)
        return per_step.reshape(b, beam, max_len), final.reshape(b, beam)
