"""k-means for the speech units: minibatch training and one-matmul
assignment (JAX reference: ops/kmeans.py).

The assignment ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2 is one matrix product
(torch.matmul, as the JAX package leaves it to XLA); training runs minibatch
updates with per-cluster learning rates (the MiniBatchKMeans rule). Seeding
and minibatch sampling draw from one numpy generator, so a seed gives the
JAX package's centroids. `kmeans_fit` and `kmeans_apply` run on CUDA unless
given device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from lip2speech_tpu_torch.pipeline.synthesise import resolve_device


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, D) features x (K, D) centroids -> (N,) nearest-centroid ids, int32."""
    x2 = x.square().sum(dim=1, keepdim=True)
    c2 = centroids.square().sum(dim=1)
    d = x2 - 2.0 * (x @ centroids.T) + c2
    return d.argmin(dim=1).to(torch.int32)


def _minibatch_update(centroids, counts, batch):
    ids = assign(batch, centroids).long()
    one_hot = torch.nn.functional.one_hot(ids, centroids.shape[0]).to(batch.dtype)
    batch_counts = one_hot.sum(dim=0)                        # (K,)
    sums = one_hot.T @ batch                                 # (K, D)
    new_counts = counts + batch_counts
    # MiniBatchKMeans: per-sample lr 1/count -> batched closed form
    lr = torch.where(batch_counts > 0, batch_counts / new_counts.clamp(min=1.0), 0.0)
    means = sums / batch_counts.clamp(min=1.0)[:, None]
    return centroids + lr[:, None] * (means - centroids), new_counts


def _kmeans_pp_init(data: np.ndarray, k: int, rng: np.random.Generator,
                    sample_cap: int = 50_000) -> np.ndarray:
    """k-means++ seeding (D^2 sampling) on a subsample."""
    if len(data) > sample_cap:
        data = data[rng.choice(len(data), sample_cap, replace=False)]
    data = data.astype(np.float32)
    cents = [data[rng.integers(len(data))]]
    d2 = ((data - cents[0]) ** 2).sum(1)
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        idx = rng.choice(len(data), p=probs)
        cents.append(data[idx])
        d2 = np.minimum(d2, ((data - cents[-1]) ** 2).sum(1))
    return np.stack(cents)


def kmeans_fit(data: np.ndarray, n_clusters: int = 200, batch_size: int = 10_000,
               n_steps: int = 500, seed: int = 0, device=None) -> np.ndarray:
    """Minibatch k-means on (N, D) features -> (K, D) float32 centroids."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    if n < n_clusters:
        raise ValueError(f"need >= {n_clusters} samples, got {n}")
    centroids = torch.as_tensor(_kmeans_pp_init(data, n_clusters, rng), dtype=torch.float32,
                                device=dev)
    counts = torch.zeros(n_clusters, dtype=torch.float32, device=dev)
    for _ in range(n_steps):
        idx = rng.integers(0, n, min(batch_size, n))
        batch = torch.as_tensor(data[idx], dtype=torch.float32, device=dev)
        centroids, counts = _minibatch_update(centroids, counts, batch)
    return centroids.cpu().numpy()


def kmeans_apply(features: np.ndarray, centroids: np.ndarray, chunk: int = 100_000,
                 device=None) -> np.ndarray:
    """Label (N, D) features -> (N,) int32 unit ids."""
    dev = resolve_device(device)
    c = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
    out = []
    for i in range(0, len(features), chunk):
        x = torch.as_tensor(features[i: i + chunk], dtype=torch.float32, device=dev)
        out.append(assign(x, c).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.int32)


def save_km(path, centroids: np.ndarray) -> None:
    np.save(path, centroids.astype(np.float32))


def load_km(path) -> np.ndarray:
    return np.load(path)
