"""Speech-unit extraction: wav -> HuBERT layer-6 features -> k-means -> .unt
(JAX reference: pipeline/units_extract.py).

  dump_features()   features of every utterance of a manifest
  learn_units()     all dumped features -> (K, D) centroids
  label_manifest()  the .unt label file parallel to a TSV manifest

The extractor runs on CUDA unless the caller passes device="cpu"; with no
card and no explicit device it raises. On the card the transformer's
attention runs the hand-written kernel of ops/attention.py.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.data.manifest import Utterance, read_manifest, write_units
from lip2speech_tpu_torch.models.hubert import HubertBase
from lip2speech_tpu_torch.models.layers import init_weights
from lip2speech_tpu_torch.ops.kmeans import kmeans_apply, kmeans_fit
from lip2speech_tpu_torch.pipeline.synthesise import resolve_device
from lip2speech_tpu_torch.utils.audio_io import read_wav

MAX_CHUNK = 1_600_000  # samples per forward chunk
_LAYER_KEY = re.compile(r"layers_(\d+)\.")


class HubertFeatureExtractor:
    def __init__(self, state: dict[str, torch.Tensor], layer: int = 6,
                 device: str | torch.device | None = None):
        """state: HubertBase state_dict, loaded with strict=True into a model
        of as many transformer layers as the state holds (a tree cut after
        `layer` layers is enough)."""
        self.device = resolve_device(device)
        self.layer = layer
        n_layers = 1 + max(int(m.group(1)) for m in map(_LAYER_KEY.match, state) if m)
        if n_layers < layer:
            raise ValueError(f"state holds {n_layers} transformer layers, need {layer}")
        self.model = HubertBase(layers=n_layers)
        self.model.load_state_dict(state, strict=True)
        self.model.eval().requires_grad_(False).to(self.device)

    @classmethod
    def from_jax_params(cls, params: dict, **kwargs) -> "HubertFeatureExtractor":
        """From the JAX package's HubertBase params (nested dicts of numpy arrays)."""
        return cls(from_jax.hubert_state_dict(params), **kwargs)

    @classmethod
    def initialize_random(cls, seed: int = 0, **kwargs) -> "HubertFeatureExtractor":
        """Random weights from one seeded torch.Generator made on the CPU."""
        model = HubertBase()
        init_weights(model, torch.Generator().manual_seed(seed))
        return cls(model.state_dict(), **kwargs)

    @torch.inference_mode()
    def features(self, wav: np.ndarray) -> np.ndarray:
        """(T_samples,) -> (T_samples / 320, 768) layer-`layer` features, at
        most MAX_CHUNK samples per forward."""
        outs = []
        for i in range(0, len(wav), MAX_CHUNK):
            chunk = torch.as_tensor(np.asarray(wav[i: i + MAX_CHUNK], np.float32),
                                    device=self.device)[None]
            outs.append(self.model(chunk, output_layer=self.layer)[0].cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0, 768), np.float32)


def _read_mono(path) -> np.ndarray:
    wav, _ = read_wav(path)
    return wav.mean(axis=1) if wav.ndim > 1 else wav


def dump_features(extractor: HubertFeatureExtractor,
                  utts: Iterable[Utterance]) -> list[np.ndarray]:
    return [extractor.features(_read_mono(utt.audio_path)) for utt in utts]


def learn_units(features: list[np.ndarray], n_clusters: int = 200, seed: int = 0,
                n_steps: int = 500, device=None) -> np.ndarray:
    """All dumped features -> (K, D) centroids."""
    return kmeans_fit(np.concatenate(features), n_clusters, seed=seed, n_steps=n_steps,
                      device=device)


def label_manifest(extractor: HubertFeatureExtractor, centroids: np.ndarray,
                   tsv_path: str | Path, unt_path: str | Path, root_override=None) -> None:
    """Write the .unt label file parallel to a TSV manifest."""
    utts = read_manifest(tsv_path, root_override=root_override)
    rows = [kmeans_apply(extractor.features(_read_mono(utt.audio_path)), centroids,
                         device=extractor.device) for utt in utts]
    write_units(unt_path, rows)
