"""Typed configuration tree of the port (its own copy; the JAX package's
core/config.py is the reference). Holds only the dataclasses the serving
slices read; the training and decode configs join as their slices land."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 16_000
    hop_length: int = 160


@dataclass(frozen=True)
class VideoConfig:
    mouth_size: int = 88


@dataclass(frozen=True)
class UnitConfig:
    """200 HuBERT units after 4 fairseq specials (bos, pad, eos, unk);
    two units and four mel frames per video frame."""

    num_units: int = 200
    num_special: int = 4
    units_per_frame: int = 2
    mel_per_frame: int = 4

    @property
    def vocab_size(self) -> int:
        return self.num_units + self.num_special


@dataclass(frozen=True)
class ConformerConfig:
    dim: int = 512
    ffn_dim: int = 2048
    heads: int = 8
    layers: int = 12
    conv_kernel: int = 31
    macaron: bool = True
    layer_norm_first: bool = True              # normalize_before
    layerscale: bool = False                   # RAVEn extension
    init_values: float = 0.1
    input_dim: int = 512                       # feature dim entering the embed Linear


@dataclass(frozen=True)
class FrontendConfig:
    """Visual frontend: "resnet3d" (Conv3d + ResNet-18, the conformer-only
    model), "avhubert" (AV-HuBERT large transformer), "auto_avsr" (frozen
    conformer encoder) or "raven" (frozen rel-MHA transformer); the encoder_*
    fields size the last three."""

    kind: str = "resnet3d"
    relu_type: str = "swish"
    frozen: bool = False
    encoder_dim: int = 512
    encoder_heads: int = 8
    encoder_ffn_dim: int = 2048
    encoder_layers: int = 12


@dataclass(frozen=True)
class MultiTargetConfig:
    """Stage 1: a frontend, the conformer and the two heads."""

    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    conformer: ConformerConfig = field(default_factory=ConformerConfig)
    units: UnitConfig = field(default_factory=UnitConfig)
    spk_emb_dim: int = 256
    mel_dim: int = 80


@dataclass(frozen=True)
class VocoderConfig:
    model_in_dim: int = 336                    # 80 mel + 128 code + 128 speaker
    num_embeddings: int = 200
    embedding_dim: int = 128
    embedder_dim: int = 256
    upsample_initial_channel: int = 512
    upsample_rates: Sequence[int] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (11, 8, 4, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


@dataclass(frozen=True)
class PipelineConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    model: MultiTargetConfig = field(default_factory=MultiTargetConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)


def _frozen_frontend(kind: str, dim: int, heads: int, ffn_dim: int, layers: int) -> dict:
    return {"frontend": FrontendConfig(kind=kind, frozen=True, encoder_dim=dim,
                                       encoder_heads=heads, encoder_ffn_dim=ffn_dim,
                                       encoder_layers=layers),
            "conformer": ConformerConfig(input_dim=dim)}


_PRESETS = {
    "multi_target": {},
    "multi_target_avhubert": _frozen_frontend("avhubert", 1024, 16, 4096, 24),
    "multi_target_auto_avsr": _frozen_frontend("auto_avsr", 768, 12, 3072, 12),
    "multi_target_raven": _frozen_frontend("raven", 1024, 16, 4096, 24),
}


def preset(name: str) -> PipelineConfig:
    """The four stage-1 variants of the JAX package's presets."""
    if name not in _PRESETS:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    base = PipelineConfig()
    return dataclasses.replace(base, model=dataclasses.replace(base.model, **_PRESETS[name]))
