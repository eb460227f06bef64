"""EMA k-means vector quantizer and the jukebox-style conv encoder / decoder
around it (JAX reference: models/vq.py; the f0-VQ stack of the reference's
CodeGenerator).

The JAX module keeps its EMA state in the mutable "vq_stats" collection;
here it is three buffers of VQBottleneck (codebook, ema_count, ema_sum),
updated in place under no_grad in training mode. The output is
straight-through: quantized + (x - x.detach()), whose gradient with respect
to x is the identity.

On purpose the dead-code restart departs from the JAX module, which draws
its row indices from a fixed jax.random.PRNGKey(0) at every call (threefry,
which torch cannot reproduce): the port draws them from the torch.Generator
the caller passes (None: the default generator of the generator's device),
on the generator's device. Every other element of the update is the JAX
module's.
"""

from __future__ import annotations

import torch
from torch import nn

from lip2speech_tpu_torch.models.layers import Conv1d, ConvTranspose1d


class VQBottleneck(nn.Module):
    """EMA k-means VQ over (B, T, D) latents."""

    def __init__(self, codebook_size: int = 64, dim: int = 128, mu: float = 0.99,
                 threshold: float = 1.0):
        super().__init__()
        self.codebook_size, self.dim = codebook_size, dim
        self.mu, self.threshold = mu, threshold
        self.register_buffer("codebook", torch.empty(codebook_size, dim))
        self.register_buffer("ema_count", torch.empty(codebook_size))
        self.register_buffer("ema_sum", torch.empty(codebook_size, dim))

    def init_random(self, gen: torch.Generator) -> None:
        """A normal codebook (converted weights carry the JAX one), counts of
        one, sums equal to the codebook."""
        with torch.no_grad():
            self.codebook.normal_(generator=gen)
            self.ema_count.fill_(1.0)
            self.ema_sum.copy_(self.codebook)

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None):
        """Returns (codes (B, T) int64, quantized (B, T, D), commit_loss,
        metrics {"entropy", "used_codes"}); in training mode the EMA update
        uses the statistics of this call, after the codes are taken."""
        k = self.codebook
        flat = x.reshape(-1, self.dim)
        d = (flat.square().sum(1, keepdim=True) - 2 * flat @ k.T + k.square().sum(1))
        codes = torch.argmin(d, dim=1)
        quantized = k[codes].reshape(x.shape)
        commit = (x - quantized.detach()).square().mean()
        quantized_st = x + (quantized - x).detach()
        one_hot = nn.functional.one_hot(codes, self.codebook_size).to(x.dtype)
        usage = one_hot.sum(0)
        if self.training:
            with torch.no_grad():
                flat_d = flat.detach()
                new_count = self.mu * self.ema_count + (1 - self.mu) * usage
                new_sum = self.mu * self.ema_sum + (1 - self.mu) * (one_hot.T @ flat_d)
                new_k = new_sum / new_count[:, None].clamp(min=1e-5)
                dead = new_count < self.threshold * usage.sum() / (self.codebook_size * 20.0)
                where = gen.device if gen is not None else flat.device
                rand_idx = torch.randint(0, flat.shape[0], (self.codebook_size,), generator=gen,
                                         device=where).to(flat.device)
                self.codebook.copy_(torch.where(dead[:, None], flat_d[rand_idx], new_k))
                self.ema_count.copy_(new_count)
                self.ema_sum.copy_(new_sum)
        probs = usage / usage.sum().clamp(min=1.0)
        entropy = -(probs * probs.clamp(min=1e-8).log()).sum()
        metrics = {"entropy": entropy, "used_codes": (usage > 0).sum().float()}
        return codes.reshape(x.shape[:-1]), quantized_st, commit, metrics


class VQEncoder(nn.Module):
    """Strided conv encoder: (B, T, in_dim) -> (B, T / prod(strides), dim)."""

    def __init__(self, dim: int = 128, strides: tuple = (4, 4), in_dim: int = 1):
        super().__init__()
        self.strides = tuple(strides)
        for i, s in enumerate(self.strides):
            self.add_module(f"down_{i}", Conv1d(in_dim if i == 0 else dim, dim, 2 * s, s // 2,
                                                stride=s))
            self.add_module(f"res_{i}a", Conv1d(dim, dim, 3, 1))
            self.add_module(f"res_{i}b", Conv1d(dim, dim, 1, 0))

    def forward(self, x):
        x = x.transpose(1, 2)
        for i in range(len(self.strides)):
            x = torch.relu(getattr(self, f"down_{i}")(x))
            x = x + getattr(self, f"res_{i}b")(torch.relu(getattr(self, f"res_{i}a")(x)))
        return x.transpose(1, 2)


class VQDecoder(nn.Module):
    """(B, T, dim) -> (B, T * prod(strides), out_dim)."""

    def __init__(self, dim: int = 128, out_dim: int = 1, strides: tuple = (4, 4)):
        super().__init__()
        self.strides = tuple(strides)
        for i, s in enumerate(reversed(self.strides)):
            self.add_module(f"res_{i}a", Conv1d(dim, dim, 3, 1))
            self.add_module(f"res_{i}b", Conv1d(dim, dim, 1, 0))
            self.add_module(f"up_{i}", ConvTranspose1d(dim, dim, 2 * s, s, s // 2))
        self.out = Conv1d(dim, out_dim, 3, 1)

    def forward(self, x):
        x = x.transpose(1, 2)
        for i in range(len(self.strides)):
            x = x + getattr(self, f"res_{i}b")(torch.relu(getattr(self, f"res_{i}a")(x)))
            x = torch.relu(getattr(self, f"up_{i}")(x))
        return self.out(x).transpose(1, 2)


class VQQuantizer(nn.Module):
    """Encoder -> VQ -> decoder (the reference Quantizer): (B, T, in_dim) ->
    (recon, codes, commit_loss, metrics)."""

    def __init__(self, dim: int = 128, codebook_size: int = 64, strides: tuple = (4, 4),
                 in_dim: int = 1):
        super().__init__()
        self.encoder = VQEncoder(dim, strides, in_dim)
        self.vq = VQBottleneck(codebook_size, dim)
        self.decoder = VQDecoder(dim, in_dim, strides)

    def forward(self, x, gen: torch.Generator | None = None):
        codes, q, commit, metrics = self.vq(self.encoder(x), gen)
        return self.decoder(q), codes, commit, metrics
