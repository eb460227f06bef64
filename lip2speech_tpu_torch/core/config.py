"""Typed configuration tree of the port (its own copy; the JAX package's
core/config.py is the reference). Holds only the dataclasses the serving
slice reads; the training and decode configs join as their slices land."""

from __future__ import annotations

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
    input_dim: int = 512


@dataclass(frozen=True)
class MultiTargetConfig:
    """Stage 1 with the conformer-only `resnet3d` frontend (the only one
    ported so far)."""

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


def preset(name: str) -> PipelineConfig:
    """Named presets; the port serves the conformer-only `multi_target`."""
    if name != "multi_target":
        raise ValueError(f"unknown preset {name!r}; available: ['multi_target']")
    return PipelineConfig()
