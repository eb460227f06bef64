"""Transformer-XL relative-position attention, forward (JAX reference:
ops/pallas_rel_attention.py, kernel `_kernel`, entry `rel_flash_attention`).

    S[i, j] = (q_u[i].k[j] + q_v[i].p[T-1-i+j]) / sqrt(dk)

Keys outside the mask score -1e30, then a row softmax multiplies V. The CUDA
kernel (csrc/rel_attention.cu) is an online-softmax flash loop that also
returns the per-row log-sum-exp; `dense_rel_attention` is its plain version.
`rel_attention` dispatches on the device of its inputs: CPU tensors take the
plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., T, 2T-1) -> (..., T, T) with out[..., i, j] = x[..., i, T-1-i+j]."""
    *lead, t, _ = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(*lead, 2 * t, t)[..., 1:, :]
    return x.reshape(*lead, t, 2 * t - 1)[..., :t]


def dense_rel_attention(q_u, q_v, k, v, p, mask) -> torch.Tensor:
    """Plain version. q_u, q_v, k, v: (B, H, T, dk); p: (H, 2T-1, dk);
    mask: (B, T) bool, True = valid key. Fully masked rows give 0."""
    dk = q_u.shape[-1]
    ac = torch.einsum("bhqd,bhkd->bhqk", q_u, k)
    bd = rel_shift(torch.einsum("bhqd,hpd->bhqp", q_v, p))
    s = (ac + bd) * (1.0 / math.sqrt(dk))
    m = mask[:, None, None, :]
    s = s.masked_fill(~m, NEG_INF)
    attn = torch.softmax(s, dim=-1).masked_fill(~m, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def rel_attention_kernel(q_u, q_v, k, v, p, mask):
    """Launch csrc/rel_attention.cu; returns (out (B,H,T,dk), lse (B,H,T) f32).
    Rows with no valid key stay finite (a uniform average of V)."""
    from lip2speech_tpu_torch.kernels import build

    b, h, t, dk = q_u.shape
    dev, dt = q_u.device, q_u.dtype
    if dev.type != "cuda":
        raise ValueError(f"rel_attention_kernel needs CUDA tensors, got {dev}")
    if dt not in _DTYPES:
        raise TypeError(f"rel_attention: dtype {dt} not supported (f32, bf16)")
    if dk != 64:
        raise ValueError(f"rel_attention kernel supports head dim 64, got {dk}")
    for name, x, shape in (("q_u", q_u, (b, h, t, dk)), ("q_v", q_v, (b, h, t, dk)),
                           ("k", k, (b, h, t, dk)), ("v", v, (b, h, t, dk)),
                           ("p", p, (h, 2 * t - 1, dk))):
        if x.shape != shape or x.dtype != dt or x.device != dev:
            raise ValueError(f"rel_attention: {name} is {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}, expected {shape} {dt} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"rel_attention: {name} must be contiguous")
    if mask.shape != (b, t) or mask.device != dev:
        raise ValueError(f"rel_attention: mask is {tuple(mask.shape)} on "
                         f"{mask.device}, expected {(b, t)} on {dev}")
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    fn = build.load("rel_attention").l2s_rel_attention
    fn.restype = ctypes.c_int
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 5 + [ptr]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(),
             p.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b, h, t, dk, _DTYPES[dt], stream)
    build.check(err, "l2s_rel_attention")
    rel_attention_kernel.launches += 1
    return out, lse


rel_attention_kernel.launches = 0   # kernel launches since the last reset


def rel_attention(q_u, q_v, k, v, p, mask) -> torch.Tensor:
    """Relative-position attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same shapes as dense_rel_attention."""
    if q_u.device.type == "cpu":
        return dense_rel_attention(q_u, q_v, k, v, p, mask)
    return rel_attention_kernel(q_u, q_v, k, v, p, mask)[0]
