"""Stage 1 in plain PyTorch: mouth video -> unit logits (50 Hz) and mel
(100 Hz), functional over a dict of the port's state-dict names.

    video (B, T, 88, 88, 1) -> ResNet-18 3D frontend (swish), or AV-HuBERT
    (PReLU ResNet-18, projections, conv positional embedding, pre-norm
    transformer, softmax attention with masked keys at -1e9)
    -> features repeated 2x in time -> Conformer (macaron FFNs, Transformer-XL
    relative-position attention, conv module with BatchNorm, LayerNorm eps
    1e-12) -> unit head (3-layer GELU MLP) and mel head (3 GELU convs, k3,
    then a linear to 2 x 80 interleaved in time)

`arch` is the configuration file's "arch" group. In training mode (`noise`
given) the recipe's dropout is drawn from `noise.gen`, a device generator,
in the order the recipe applies it, and the per-layer attention-dropout
seeds from `noise.seed_gen` on the host; the attention dropout mask is
reference.philox's. BatchNorm takes batch statistics in training and its
running statistics otherwise; an AV-HuBERT frontend always runs in eval
mode, without gradient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.philox import keep_mask


@dataclass
class Noise:
    gen: torch.Generator            # dropout draws, on the model's device
    seed_gen: torch.Generator       # attention-dropout seeds, on the host

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device, generator=self.gen) >= rate
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)


def _drop(noise: Noise | None, x, rate):
    return x if noise is None else noise.drop(x, rate)


def lin(P, name, x):
    return F.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def conv1d(P, name, x, padding=0, groups=1):
    y = F.conv1d(x, P[name + ".weight"], None, 1, padding, 1, groups)
    b = P.get(name + ".bias")
    return y if b is None else y + b[None, :, None]


def bn(P, name, x, train: bool):
    if train:
        return F.batch_norm(x, None, None, P[name + ".weight"], P[name + ".bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, P[name + ".running_mean"], P[name + ".running_var"],
                        P[name + ".weight"], P[name + ".bias"], False, 0.0, 1e-5)


def ln(P, name, x, eps=1e-12):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], eps)


def _act(P, name, x, kind):
    if kind == "swish":
        return x * torch.sigmoid(x)
    a = P[name + ".weight"].reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, a * x)


# ---------------------------------------------------------------- frontends

def resnet3d(P, pre, video, train: bool, act: str = "swish"):
    """(B, T, H, W, 1) -> (B, T, 512)."""
    b, t = video.shape[:2]
    x = F.conv3d(video.permute(0, 4, 1, 2, 3), P[pre + ".stem_conv.weight"], None,
                 (1, 2, 2), (2, 3, 3))
    x = _act(P, pre + ".act", bn(P, pre + ".stem_bn", x, train), act)
    x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    x = x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])
    for stage, stride in enumerate((1, 2, 2, 2)):
        for blk in range(2):
            p = f"{pre}.trunk.layer{stage + 1}_{blk}"
            s = stride if blk == 0 else 1
            out = F.conv2d(x, P[p + ".conv1.weight"], None, s, 1)
            out = _act(P, p + ".act1", bn(P, p + ".bn1", out, train), act)
            out = bn(P, p + ".bn2", F.conv2d(out, P[p + ".conv2.weight"], None, 1, 1), train)
            if p + ".downsample_conv.weight" in P:
                x = bn(P, p + ".downsample_bn",
                       F.conv2d(x, P[p + ".downsample_conv.weight"], None, s, 0), train)
            x = _act(P, p + ".act2", out + x, act)
    return x.mean(dim=(2, 3)).reshape(b, t, -1)


def avhubert(P, pre, video, mask, a: dict):
    """Video-only AV-HuBERT encoder in eval mode: (B, T, 88, 88, 1) -> (B, T, D)."""
    feats_v = lin(P, pre + ".video_proj", resnet3d(P, pre + ".resnet", video, False, "prelu"))
    fused = ln(P, pre + ".fuse_layer_norm", torch.cat([torch.zeros_like(feats_v), feats_v], -1),
               1e-5)
    x = lin(P, pre + ".post_extract_proj", fused)
    x = torch.where(mask[:, :, None], x, 0.0)
    k = 128
    y = conv1d(P, pre + ".encoder.pos_conv.conv", x.transpose(1, 2), k // 2, 16)[:, :, :-1]
    x = x + F.gelu(y).transpose(1, 2)
    b, t, d = x.shape
    h = a["heads"]
    dk = d // h
    heads = lambda y: y.reshape(b, t, h, dk).transpose(1, 2)  # noqa: E731
    for i in range(a["layers"]):
        p = f"{pre}.encoder.layers_{i}"
        y = ln(P, p + ".self_attn_layer_norm", x, 1e-5)
        q, kk, v = (heads(lin(P, f"{p}.self_attn.{n}_proj", y)) for n in "qkv")
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk) / math.sqrt(dk)
        s = s.masked_fill(~mask[:, None, None, :], -1e9)
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
        x = x + lin(P, p + ".self_attn.out_proj", o.transpose(1, 2).reshape(b, t, d))
        y = ln(P, p + ".final_layer_norm", x, 1e-5)
        x = x + lin(P, p + ".fc2", F.gelu(lin(P, p + ".fc1", y)))
    return ln(P, pre + ".encoder.layer_norm", x, 1e-5)


# ---------------------------------------------------------------- conformer

def rel_pos_table(length: int, d: int) -> np.ndarray:
    """(2L-1, d): row 0 is relative position +(L-1), the last -(L-1)."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(np.log(10000.0) / d))
    out = []
    for sign in (1.0, -1.0):
        pe = np.zeros((length, d), dtype=np.float32)
        pe[:, 0::2] = np.sin(sign * pos * div)
        pe[:, 1::2] = np.cos(sign * pos * div)
        out.append(pe)
    return np.concatenate([out[0][::-1], out[1][1:]], axis=0)


def rel_shift(x):
    """(..., T, 2T-1) -> (..., T, T), out[..., i, j] = x[..., i, T-1-i+j]."""
    *lead, t, _ = x.shape
    x = F.pad(x, (1, 0)).reshape(*lead, 2 * t, t)[..., 1:, :]
    return x.reshape(*lead, t, 2 * t - 1)[..., :t]


def rel_attention(q_u, q_v, k, v, p, mask, seed: int, rate: float):
    """q_*, k, v (B, H, T, dk); p (H, 2T-1, dk); mask (B, T) valid keys."""
    b, h, t, dk = q_u.shape
    s = (torch.einsum("bhqd,bhkd->bhqk", q_u, k)
         + rel_shift(torch.einsum("bhqd,hpd->bhqp", q_v, p))) / math.sqrt(dk)
    m = mask[:, None, None, :]
    a = torch.softmax(s.masked_fill(~m, -1e30), -1).masked_fill(~m, 0.0)
    if rate > 0.0:
        a = a * keep_mask(seed, rate, b, h, t, q_u.device).to(a.dtype) * (1.0 / (1.0 - rate))
    return torch.einsum("bhqk,bhkd->bhqd", a, v)


def conformer(P, pre, x, mask, c: dict, noise: Noise | None):
    train = noise is not None
    d, h = c["dim"], c["heads"]
    dk = d // h
    x = lin(P, pre + ".embed", x)
    b, t, _ = x.shape
    pe = torch.tensor(rel_pos_table(t, d), dtype=x.dtype, device=x.device)
    x = x * float(math.sqrt(d))
    seeds = [0] * c["layers"]
    if train:
        x = noise.drop(x, c["dropout"])
        pe = noise.drop(pe, c["dropout"])
        seeds = torch.randint(0, 2 ** 31 - 1, (c["layers"],), generator=noise.seed_gen).tolist()
    heads = lambda y: y.reshape(b, -1, h, dk).transpose(1, 2)  # noqa: E731
    for i in range(c["layers"]):
        p = f"{pre}.layers_{i}"

        def ffn(name, y):
            y = torch.relu(lin(P, f"{p}.{name}.w_1", y))
            return lin(P, f"{p}.{name}.w_2", _drop(noise, y, c["dropout"]))

        def mha(y, i=i):
            a = f"{p}.self_attn"
            q = lin(P, a + ".linear_q", y).reshape(b, t, h, dk)
            q_u = (q + P[a + ".pos_bias_u"]).transpose(1, 2)
            q_v = (q + P[a + ".pos_bias_v"]).transpose(1, 2)
            pos = lin(P, a + ".linear_pos", pe).reshape(1, -1, h, dk).transpose(1, 2)[0]
            args = (q_u, q_v, heads(lin(P, a + ".linear_k", y)), heads(lin(P, a + ".linear_v", y)),
                    pos, mask, seeds[i], c["attention_dropout"] if train else 0.0)
            # recomputed in the backward (the mask is a function of the seed):
            # only the inputs of each layer's scores stay in memory
            o = (checkpoint(rel_attention, *args, use_reentrant=False, preserve_rng_state=False)
                 if torch.is_grad_enabled() else rel_attention(*args))
            return lin(P, a + ".linear_out", o.transpose(1, 2).reshape(b, t, d))

        def conv(y):
            y = conv1d(P, p + ".conv_module.pointwise_conv1", y.transpose(1, 2))
            y = y[:, :d] * torch.sigmoid(y[:, d:])
            y = conv1d(P, p + ".conv_module.depthwise_conv", y, (c["conv_kernel"] - 1) // 2, d)
            y = bn(P, p + ".conv_module.norm", y, train)
            y = conv1d(P, p + ".conv_module.pointwise_conv2", y * torch.sigmoid(y))
            return y.transpose(1, 2)

        for name, fn, scale in (("ff_macaron", lambda y: ffn("feed_forward_macaron", y), 0.5),
                                ("mha", mha, 1.0), ("conv", conv, 1.0),
                                ("ff", lambda y: ffn("feed_forward", y), 0.5)):
            y = _drop(noise, fn(ln(P, f"{p}.norm_{name}", x)), c["dropout"])
            x = x + (scale * y if scale != 1.0 else y)
        x = ln(P, p + ".norm_final", x)
    return ln(P, pre + ".after_norm", x)


# ---------------------------------------------------------------- heads, model

def mel_head(P, x, spk, noise, rate):
    b, t, _ = x.shape
    y = torch.cat([spk[:, :, None].expand(b, spk.shape[1], t), x.transpose(1, 2)], 1)
    for i in range(3):
        y = F.gelu(_drop(noise, conv1d(P, f"mel_head.conv{i}", y, 1), rate))
    y = lin(P, "mel_head.proj", y.transpose(1, 2))
    n_mel = y.shape[-1] // 2
    return y.reshape(b, t, n_mel, 2).transpose(2, 3).reshape(b, 2 * t, n_mel)


def unit_head(P, x, noise, rate):
    for name in ("fc0", "fc1"):
        x = _drop(noise, F.gelu(lin(P, f"unit_head.{name}", x)), rate)
    return lin(P, "unit_head.last", x)


def forward(P, arch: dict, video, frames_mask, spk, noise: Noise | None = None) -> dict:
    """video (B, T, 88, 88, 1) normalised; frames_mask (B, T); spk (B, 256).
    Returns unit_logits (B, 2T, V), mel (B, 4T, 80), mask (B, 2T)."""
    if arch["frontend"] == "avhubert":
        with torch.no_grad():
            feats = avhubert(P, "frontend", video, frames_mask, arch["avhubert"])
    else:
        feats = resnet3d(P, "frontend", video, noise is not None)
    x = torch.repeat_interleave(feats, 2, dim=1)
    mask = torch.repeat_interleave(frames_mask, 2, dim=1)
    x = conformer(P, "conformer", x, mask, arch["conformer"], noise)
    rate = arch["final_dropout"]
    mel = mel_head(P, x, spk, noise, rate)
    logits = unit_head(P, _drop(noise, x, rate), noise, rate)
    return {"unit_logits": logits, "mel": mel, "mask": mask}
