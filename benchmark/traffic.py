"""The one generator of every traffic mix (traffic/<mix>.json): clip lengths
drawn as stratified quantiles of the mix's distribution, so that every seed
gives the same multiset of lengths and only their order changes; a mix that
names a `segment` draws video lengths, each sent as the long-video worker
cuts it."""

from __future__ import annotations

import math

import numpy as np


def _quantile(spec: dict, u: np.ndarray) -> np.ndarray:
    lo, hi = spec["low"], spec["high"]
    if spec["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
    elif spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n lengths in [low, high]: the (i + 1/2)/n quantiles of `uniform` or
    `loguniform` over the range, in an order drawn from rng."""
    return rng.permutation(_quantile(spec, (np.arange(n) + 0.5) / n))


def client_lengths(spec: dict, n: int, rng: np.random.Generator, client: int, clients: int,
                   block: int) -> np.ndarray:
    """The n lengths one of `clients` closed-loop clients sends: blocks of
    `block`, each block the same quantiles (client c takes the c-th of each
    group of `clients` neighbouring ones) in an order drawn anew from rng.
    Any whole number of blocks holds the same lengths for every seed, so
    the work a window completes depends on the seed only through its last,
    partial block."""
    u = (np.arange(block) * clients + client + 0.5) / (block * clients)
    base = _quantile(spec, u)
    return np.concatenate([rng.permutation(base) for _ in range(-(-n // block))])[:n]


def segments(n: int, segment: int | None) -> list[int]:
    """The clips a video of n frames is sent as: the long-video worker's cut
    (`pipeline/server.py` synthesise_long_video) into whole segments of
    `segment` frames and the rest; without a segment, the video whole."""
    if not segment:
        return [n]
    whole, rest = divmod(n, segment)
    return [segment] * whole + ([rest] if rest else [])


def unit_speaker(rng: np.random.Generator, n: int, dim: int = 256) -> np.ndarray:
    """n speaker embeddings of norm 1 (d-vectors are length-normalised)."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)
