"""Typed configuration tree of the port (its own copy; the JAX package's
core/config.py is the reference). Holds the dataclasses the ported code
reads (serving, stage-1 and stage-2 training), the presets and
`with_overrides`; the decode config joins when that part is ported. The JAX
package's vocoder switches mxu_fold, fold_tail (TPU lane layouts) and
fused_tail_kernel have no counterpart here: on the card every <=128-channel
generator stage runs the trio kernel."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class AudioConfig:
    """The dataset mel (Tacotron-style, centred: 640/160/640, 80 bins from 0
    to 8 kHz, reference create_dataset.py:62-75), and the vocoder's mel-loss
    STFT (1024/256/1024, 80 bins from fmin, fmax None: the Nyquist rate)."""

    sample_rate: int = 16_000
    n_fft: int = 640
    hop_length: int = 160
    win_length: int = 640
    num_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    loss_n_fft: int = 1024
    loss_hop_length: int = 256
    loss_win_length: int = 1024
    loss_fmax: float | None = None


@dataclass(frozen=True)
class VideoConfig:
    mouth_size: int = 88
    max_frames: int = 600                      # a file is cut to 24 s at 25 fps


@dataclass(frozen=True)
class UnitConfig:
    """200 HuBERT units after 4 fairseq specials (bos, pad, eos, unk);
    two units and four mel frames per video frame."""

    num_units: int = 200
    bos: int = 0
    pad: int = 1
    eos: int = 2
    unk: int = 3
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
    dropout: float = 0.1                       # residual, FFN and positional
    attention_dropout: float = 0.1
    conv_kernel: int = 31
    macaron: bool = True
    layer_norm_first: bool = True              # normalize_before
    layerscale: bool = False                   # RAVEn extension
    init_values: float = 0.1
    drop_path: float = 0.0                     # stochastic depth, rising per layer
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
    final_dropout: float = 0.1
    text_supervision: bool = False
    text_vocab_size: int = 0


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
    segment_size: int = 8960                   # stage-2 training segment, samples
    code_hop_size: int = 320
    mel_hop_size: int = 160


@dataclass(frozen=True)
class Stage1TrainConfig:
    """Stage-1 optimisation: Adam(0.9, 0.98) with decoupled weight decay,
    linear warm-up then cosine decay, clip-norm 10, gradients of the summed
    loss over `update_freq` micro-batches divided by the summed sample size."""

    lr: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_updates: int = 10_000
    max_updates: int = 150_000
    clip_norm: float = 10.0
    update_freq: int = 8                       # gradient accumulation
    label_smoothing: float = 0.1
    mel_weight: float = 10.0
    text_weight: float = 1.0
    sentence_avg: bool = True
    max_sample_size: int = 600
    batch_size: int = 8
    seed: int = 1337
    freeze_finetune_updates: int = 0
    # forward and backward in bf16 with f32 master weights, f32 optimizer
    # state, f32 BatchNorm statistics and f32 losses; no loss scaling
    bf16_compute: bool = False


@dataclass(frozen=True)
class Stage2TrainConfig:
    """Stage-2 GAN optimisation: AdamW(0.8, 0.99, eps 1e-8, weight decay
    0.01) for the generator and one for both discriminators, the rate decayed
    by lr_decay per epoch; mel L1 x lambda_mel. The JAX config's lambda_fm
    is read by neither trainer (the feature loss doubles itself) and its
    mel_aug is the dataset's argument (data/stage2.py), so neither is here."""

    lr: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999                    # ExponentialLR gamma per epoch
    batch_size: int = 16
    seed: int = 1234
    lambda_mel: float = 45.0


@dataclass(frozen=True)
class PipelineConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    model: MultiTargetConfig = field(default_factory=MultiTargetConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    stage1: Stage1TrainConfig = field(default_factory=Stage1TrainConfig)
    stage2: Stage2TrainConfig = field(default_factory=Stage2TrainConfig)


def _replace_nested(cfg: Any, updates: dict[str, Any]) -> Any:
    kwargs: dict[str, Any] = {}
    for key, value in updates.items():
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _replace_nested(current, value)
        else:
            kwargs[key] = value
    return dataclasses.replace(cfg, **kwargs)


def with_overrides(cfg: Any, overrides: dict[str, Any]) -> Any:
    """A copy of a (nested) dataclass config with updates applied. Keys are
    dotted paths or nested dicts: {"model.conformer.dim": 256}."""
    nested: dict[str, Any] = {}
    for key, value in overrides.items():
        parts = key.split(".")
        node = nested
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _replace_nested(cfg, nested)


def _frozen_frontend(kind: str, dim: int, heads: int, ffn_dim: int, layers: int) -> dict:
    return {"model.frontend": FrontendConfig(kind=kind, frozen=True, encoder_dim=dim,
                                             encoder_heads=heads, encoder_ffn_dim=ffn_dim,
                                             encoder_layers=layers),
            "model.conformer": ConformerConfig(input_dim=dim)}


_PRESETS = {
    "multi_target": {},
    # a few narrow layers for tests and smoke runs (not a reference config)
    "tiny": {
        "model.conformer": ConformerConfig(dim=32, ffn_dim=64, heads=2, layers=1,
                                           input_dim=512),
        "vocoder": VocoderConfig(model_in_dim=80 + 2 * 8, embedding_dim=8,
                                 upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                                 resblock_dilation_sizes=((1, 3, 5),)),
        "stage1": Stage1TrainConfig(update_freq=1, batch_size=2, warmup_updates=2,
                                    max_updates=4),
    },
    "multi_target_avhubert": _frozen_frontend("avhubert", 1024, 16, 4096, 24),
    "multi_target_auto_avsr": _frozen_frontend("auto_avsr", 768, 12, 3072, 12),
    "multi_target_raven": _frozen_frontend("raven", 1024, 16, 4096, 24),
}


def preset(name: str) -> PipelineConfig:
    """The JAX package's presets: the four stage-1 variants and `tiny`."""
    if name not in _PRESETS:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return with_overrides(PipelineConfig(), _PRESETS[name])
