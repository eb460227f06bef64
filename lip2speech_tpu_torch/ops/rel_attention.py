"""Transformer-XL relative-position attention, forward (JAX reference:
ops/pallas_rel_attention.py, kernel `_kernel`, entry `rel_flash_attention`).

    S[i, j] = (q_u[i].k[j] + q_v[i].p[T-1-i+j]) / sqrt(dk)

Keys outside the mask score -1e30, then a row softmax multiplies V. Two
implementations, selected by `impl` (default: the LIP2SPEECH_FLASH_IMPL
environment variable, "shear" when unset):

  "shear"  csrc/rel_attention.cu computes the position term inside its
           online-softmax flash loop; plain version `dense_rel_attention`.
  "bias"   (JAX: `_bias_kernel`, entry `_rel_flash_bias`) the position term
           is built outside as an additive f32 (B, H, T, T) bias,
           `rel_position_bias`, and csrc/rel_attention_bias.cu is a flash
           loop with one additive tile; plain version `dense_bias_attention`.

Both kernels also return the per-row log-sum-exp. `rel_attention` dispatches
on the device of its inputs: CPU tensors take the plain version, CUDA tensors
the kernel. Forward only, no dropout: the backward kernels and in-kernel
dropout come with the training modules.
"""

from __future__ import annotations

import ctypes
import math
import os

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


def rel_position_bias(q_v, p) -> torch.Tensor:
    """The position term as an additive bias, in f32 whatever the input type:
    rel_shift(q_v . p^T) / sqrt(dk), (B, H, T, T)."""
    bd = torch.einsum("bhqd,hpd->bhqp", q_v.float(), p.float())
    return rel_shift(bd) * (1.0 / math.sqrt(q_v.shape[-1]))


def dense_bias_attention(q_u, k, v, bias, mask) -> torch.Tensor:
    """Plain version of the bias kernel. q_u, k, v: (B, H, T, dk); bias:
    (B, H, T, T) f32; mask: (B, T) bool. Fully masked rows give 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q_u, k) * (1.0 / math.sqrt(q_u.shape[-1])) + bias
    m = mask[:, None, None, :]
    s = s.masked_fill(~m, NEG_INF)
    attn = torch.softmax(s, dim=-1).masked_fill(~m, 0.0).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def _check_inputs(what: str, tensors, mask, b: int, t: int) -> None:
    """tensors: (name, tensor, shape, dtype); all on the first one's device."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{what}_kernel needs CUDA tensors, got {dev}")
    if tensors[0][3] not in _DTYPES:
        raise TypeError(f"{what}: dtype {tensors[0][3]} not supported (f32, bf16)")
    for name, x, shape, dt in tensors:
        if x.shape != shape or x.dtype != dt or x.device != dev:
            raise ValueError(f"{what}: {name} is {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}, expected {shape} {dt} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if mask.shape != (b, t) or mask.device != dev:
        raise ValueError(f"{what}: mask is {tuple(mask.shape)} on "
                         f"{mask.device}, expected {(b, t)} on {dev}")


def rel_attention_kernel(q_u, q_v, k, v, p, mask):
    """Launch csrc/rel_attention.cu; returns (out (B,H,T,dk), lse (B,H,T) f32).
    Rows with no valid key stay finite (a uniform average of V)."""
    from lip2speech_tpu_torch.kernels import build

    b, h, t, dk = q_u.shape
    dev, dt = q_u.device, q_u.dtype
    if dk != 64:
        raise ValueError(f"rel_attention kernel supports head dim 64, got {dk}")
    _check_inputs("rel_attention", [("q_u", q_u, (b, h, t, dk), dt), ("q_v", q_v, (b, h, t, dk), dt),
                                    ("k", k, (b, h, t, dk), dt), ("v", v, (b, h, t, dk), dt),
                                    ("p", p, (h, 2 * t - 1, dk), dt)], mask, b, t)
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


def rel_attention_bias_kernel(q_u, k, v, bias, mask):
    """Launch csrc/rel_attention_bias.cu; returns (out (B,H,T,dk), lse (B,H,T)
    f32). bias is (B, H, T, T) float32 whatever the type of q_u, k, v. Rows
    with no valid key stay finite."""
    from lip2speech_tpu_torch.kernels import build

    b, h, t, dk = q_u.shape
    dev, dt = q_u.device, q_u.dtype
    if dk != 64:
        raise ValueError(f"rel_attention_bias kernel supports head dim 64, got {dk}")
    _check_inputs("rel_attention_bias", [("q_u", q_u, (b, h, t, dk), dt), ("k", k, (b, h, t, dk), dt),
                                         ("v", v, (b, h, t, dk), dt),
                                         ("bias", bias, (b, h, t, t), torch.float32)], mask, b, t)
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    fn = build.load("rel_attention_bias").l2s_rel_attention_bias
    fn.restype = ctypes.c_int
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 7 + [ctypes.c_int] * 5 + [ptr]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q_u.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             mask_u8.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b, h, t, dk, _DTYPES[dt], stream)
    build.check(err, "l2s_rel_attention_bias")
    rel_attention_bias_kernel.launches += 1
    return out, lse


rel_attention_bias_kernel.launches = 0   # kernel launches since the last reset


def rel_attention(q_u, q_v, k, v, p, mask, impl: str | None = None,
                  dropout_rate: float = 0.0) -> torch.Tensor:
    """Relative-position attention: a CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. Shapes as dense_rel_attention. impl: "shear" or
    "bias" (None: LIP2SPEECH_FLASH_IMPL, else "shear")."""
    impl = impl or os.environ.get("LIP2SPEECH_FLASH_IMPL", "shear")
    if impl not in ("bias", "shear"):
        raise ValueError(f"unknown flash impl {impl!r} (bias|shear)")
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout inside the kernels is not ported "
                                  "yet; it comes with the stage-1 training modules")
    on_cpu = q_u.device.type == "cpu"
    if impl == "shear":
        if on_cpu:
            return dense_rel_attention(q_u, q_v, k, v, p, mask)
        return rel_attention_kernel(q_u, q_v, k, v, p, mask)[0]
    bias = rel_position_bias(q_v, p)
    if on_cpu:
        return dense_bias_attention(q_u, k, v, bias, mask)
    return rel_attention_bias_kernel(q_u, k, v, bias, mask)[0]
