"""Key-masked softmax attention of the wav2vec2-style trunks (JAX reference:
ops/pallas_attention.py, kernel `_attn_kernel`, entry `flash_attention` /
`attention`).

    O = softmax_j(q.k^T / sqrt(dk), keys outside the mask excluded) V

The CUDA kernel (csrc/attention.cu, the forward of csrc/flash_fwd_hopper.cuh
without the position term) is an online-softmax flash loop over key tiles on
Hopper's warpgroup products (wgmma), fed by TMA: bf16 with f32 accumulation,
f32 in 3xTF32 (each operand split into a TF32 hi and an f32 lo, three TF32
products for each f32 one, f32 accumulation); `reference_attention` is its
plain version. `attention` dispatches on
the device of its inputs: CPU tensors take the plain version, CUDA tensors
the kernel through `AttentionFn`. The JAX entry's backward is a dense
recompute outside any kernel (the vjp of its reference attention), so
`AttentionFn.backward` is the same in plain PyTorch: autograd through
`reference_attention` on the saved inputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, mask=None) -> torch.Tensor:
    """Plain version. q, k, v: (B, H, T, dk); mask: (B, T) bool, True = valid
    key, or None for all keys valid. Masked keys score -1e9 (fairseq), so a
    row whose keys are all masked gives a uniform average of V."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], -1e9)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def attention_kernel(q, k, v, mask=None) -> torch.Tensor:
    """Launch csrc/attention.cu; returns out (B, H, T, dk). A block of 384
    threads (a TMA producer warpgroup, two consumer warpgroups on wgmma)
    owns 128 query rows in bf16, 64 in f32, where the two warpgroups take
    alternate key tiles and combine at the end. f32 runs in 3xTF32 (within 3e-5 of
    reference_attention with TF32 off), bf16 with f32 accumulation and P
    rounded to bf16. Rows with no valid key stay finite (a uniform average
    of V). Not differentiable by itself: see AttentionFn."""
    from lip2speech_tpu_torch.kernels import build

    b, h, t, dk = q.shape
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"attention_kernel needs CUDA tensors, got {dev}")
    if dt not in _DTYPES:
        raise TypeError(f"attention: dtype {dt} not supported (f32, bf16)")
    if dk != 64:
        raise ValueError(f"attention kernel supports head dim 64, got {dk}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != dt or x.device != dev:
            raise ValueError(f"attention: {name} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}, expected {tuple(q.shape)} {dt} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"attention: {name} must be contiguous")
    mask_ptr = None                                   # NULL: every key valid
    if mask is not None:
        if mask.shape != (b, t) or mask.device != dev:
            raise ValueError(f"attention: mask is {tuple(mask.shape)} on "
                             f"{mask.device}, expected {(b, t)} on {dev}")
        mask_u8 = mask.to(torch.uint8).contiguous()
        mask_ptr = mask_u8.data_ptr()
    out = torch.empty_like(q)
    fn = build.load("attention").l2s_attention
    fn.restype = ctypes.c_int
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 5 + [ctypes.c_int] * 5 + [ptr]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
             b, h, t, dk, _DTYPES[dt], stream)
    build.check(err, "l2s_attention")
    attention_kernel.launches += 1
    return out


attention_kernel.launches = 0   # kernel launches since the last reset


class AttentionFn(torch.autograd.Function):
    """The kernel forward with a dense-recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v)
        ctx.mask = mask
        return attention_kernel(q, k, v, mask)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            out = reference_attention(q, k, v, ctx.mask)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def attention(q, k, v, mask=None) -> torch.Tensor:
    """Masked attention, differentiable: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same shapes as reference_attention."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, mask)
    return AttentionFn.apply(q, k, v, mask)
