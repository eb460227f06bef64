"""Transformer-XL relative-position attention, forward and backward (JAX
reference: ops/pallas_rel_attention.py, kernels `_kernel`, `_bwd_kernel`,
`_bias_kernel`, `_bias_bwd_kernel`; entry `rel_flash_attention`).

    S[i, j] = (q_u[i].k[j] + q_v[i].p[T-1-i+j]) / sqrt(dk)

Keys outside the mask score -1e30, then a row softmax multiplies V. With
dropout the product with V sees the probabilities times keep / (1 - rate);
the softmax sum does not. Two implementations, selected by `impl` (default:
the LIP2SPEECH_FLASH_IMPL environment variable, "shear" when unset):

  "shear"  csrc/rel_attention.cu (the forward of csrc/flash_fwd_hopper.cuh,
           on wgmma, fed by TMA) computes the position term inside its
           online-softmax flash loop and csrc/rel_attention_bwd.cu all five
           gradients; plain versions `dense_rel_attention` and
           `rel_attention_bwd_plain`; autograd through `RelAttentionFn`.
  "bias"   (JAX: entry `_rel_flash_bias`) the position term is built outside
           as an additive f32 (B, H, T, T) bias, `rel_position_bias`;
           csrc/rel_attention_bias.cu (the bias variant of
           csrc/flash_fwd_hopper.cuh's wgmma forward: each thread loads the
           bias of its scores a tile ahead) and csrc/rel_attention_bias_bwd.cu
           (one TMA-fed key-major pass) returns dq_u, dk, dv and dbias (dq_u
           by f32 reductions);
           the gradients of q_v and p flow through `rel_position_bias` by
           PyTorch's autograd. Plain versions `dense_bias_attention` and
           `bias_attention_bwd_plain`; autograd through `BiasAttentionFn`.

The forward kernels also return the per-row log-sum-exp, from which the
backward kernels recompute the probabilities. The dropout mask is a function
of (seed, b*h, i, j) (csrc/philox.cuh; ops/dropout_mask.py computes the same
mask with tensor ops), so forward and backward agree and the plain versions
can be given the identical mask through `keep=`. `rel_attention` dispatches
on the device of its inputs: CPU tensors take the plain version (and
PyTorch's own autograd), CUDA tensors the kernels.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from lip2speech_tpu_torch.ops.dropout_mask import attention_keep_mask

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., T, 2T-1) -> (..., T, T) with out[..., i, j] = x[..., i, T-1-i+j]."""
    *lead, t, _ = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(*lead, 2 * t, t)[..., 1:, :]
    return x.reshape(*lead, t, 2 * t - 1)[..., :t]


def _drop(attn: torch.Tensor, keep, rate: float) -> torch.Tensor:
    """The probabilities as the product with V sees them under dropout."""
    if keep is None:
        return attn
    return attn * keep.to(attn.dtype) * (1.0 / (1.0 - rate))


def rel_scores(q_u, q_v, k, p) -> torch.Tensor:
    """Scaled scores (B, H, T, T) before masking."""
    ac = torch.einsum("bhqd,bhkd->bhqk", q_u, k)
    bd = rel_shift(torch.einsum("bhqd,hpd->bhqp", q_v, p))
    return (ac + bd) * (1.0 / math.sqrt(q_u.shape[-1]))


def bias_scores(q_u, k, bias) -> torch.Tensor:
    return torch.einsum("bhqd,bhkd->bhqk", q_u, k) * (1.0 / math.sqrt(q_u.shape[-1])) + bias


def masked_lse(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row log-sum-exp (B, H, T) of scores with masked keys at -1e30, as the
    forward kernels return it."""
    return torch.logsumexp(s.float().masked_fill(~mask[:, None, None, :], NEG_INF), dim=-1)


def _masked_softmax(s, mask):
    m = mask[:, None, None, :]
    return torch.softmax(s.masked_fill(~m, NEG_INF), dim=-1).masked_fill(~m, 0.0)


def dense_rel_attention(q_u, q_v, k, v, p, mask, keep=None, rate: float = 0.0) -> torch.Tensor:
    """Plain version. q_u, q_v, k, v: (B, H, T, dk); p: (H, 2T-1, dk);
    mask: (B, T) bool, True = valid key. Fully masked rows give 0. keep:
    (B, H, T, T) bool dropout mask (True = kept) applied at `rate`, or None."""
    attn = _drop(_masked_softmax(rel_scores(q_u, q_v, k, p), mask), keep, rate)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def rel_position_bias(q_v, p) -> torch.Tensor:
    """The position term as an additive bias, in f32 whatever the input type:
    rel_shift(q_v . p^T) / sqrt(dk), (B, H, T, T)."""
    bd = torch.einsum("bhqd,hpd->bhqp", q_v.float(), p.float())
    return rel_shift(bd) * (1.0 / math.sqrt(q_v.shape[-1]))


def dense_bias_attention(q_u, k, v, bias, mask, keep=None, rate: float = 0.0) -> torch.Tensor:
    """Plain version of the bias kernel. q_u, k, v: (B, H, T, dk); bias:
    (B, H, T, T) f32; mask: (B, T) bool. Fully masked rows give 0. keep, rate
    as in dense_rel_attention."""
    attn = _drop(_masked_softmax(bias_scores(q_u, k, bias), mask), keep, rate).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def rel_unshift(x: torch.Tensor) -> torch.Tensor:
    """Transpose of rel_shift: (..., T, T) -> (..., T, 2T-1) with
    out[..., i, T-1-i+j] = x[..., i, j] and zeros elsewhere."""
    t = x.shape[-1]
    ar = torch.arange(t, device=x.device)
    idx = (t - 1 - ar[:, None] + ar[None, :]).expand(x.shape)
    return x.new_zeros(*x.shape[:-1], 2 * t - 1).scatter_(-1, idx, x)


def _backward_common(s, mask, lse, out, g, v, keep, rate):
    """P~ (what multiplied V) and dS = P o (dO V^T o keep/(1-rate) - D),
    unscaled, in f32. Rows whose log-sum-exp is below -1e30 / 2 had no valid
    key and get P = 0."""
    valid = mask[:, None, None, :] & (lse > NEG_INF / 2)[..., None]
    prob = torch.where(valid, torch.exp(s.float() - lse[..., None]), 0.0)
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    dpr = _drop(torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float()), keep, rate)
    return _drop(prob, keep, rate), prob * (dpr - delta)


def rel_attention_bwd_plain(q_u, q_v, k, v, p, mask, lse, out, g, keep=None, rate: float = 0.0):
    """Plain version of csrc/rel_attention_bwd.cu, written from its formulas:
    the gradients (dq_u, dq_v, dk, dv, dp) of the shear route for the upstream
    gradient g, from the forward's inputs, its output `out` and its row
    log-sum-exp `lse` (B, H, T). f32 arithmetic; results in the input type."""
    dt = q_u.dtype
    f = [x.float() for x in (q_u, q_v, k, v, p)]
    p_drop, ds = _backward_common(rel_scores(f[0], f[1], f[2], f[4]), mask, lse, out, g, v,
                                  keep, rate)
    ds = ds * (1.0 / math.sqrt(q_u.shape[-1]))
    dg = rel_unshift(ds)                                     # (B, H, T, 2T-1)
    grads = (torch.einsum("bhqk,bhkd->bhqd", ds, f[2]),
             torch.einsum("bhqp,hpd->bhqd", dg, f[4]),
             torch.einsum("bhqk,bhqd->bhkd", ds, f[0]),
             torch.einsum("bhqk,bhqd->bhkd", p_drop, g.float()),
             torch.einsum("bhqp,bhqd->hpd", dg, f[1]))
    return tuple(x.to(dt) for x in grads)


def bias_attention_bwd_plain(q_u, k, v, bias, mask, lse, out, g, keep=None, rate: float = 0.0):
    """Plain version of csrc/rel_attention_bias_bwd.cu: (dq_u, dk, dv, dbias)
    with dbias (B, H, T, T) f32 and unscaled."""
    dt = q_u.dtype
    f = [x.float() for x in (q_u, k, v)]
    p_drop, ds = _backward_common(bias_scores(f[0], f[1], bias), mask, lse, out, g, v, keep, rate)
    scale = 1.0 / math.sqrt(q_u.shape[-1])
    return (torch.einsum("bhqk,bhkd->bhqd", ds, f[1]).mul_(scale).to(dt),
            torch.einsum("bhqk,bhqd->bhkd", ds, f[0]).mul_(scale).to(dt),
            torch.einsum("bhqk,bhqd->bhkd", p_drop, g.float()).to(dt), ds)


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


def _launch(lib: str, fn_name: str, pointers, b, h, t, dk, dt, rate: float, seed: int, dev):
    from lip2speech_tpu_torch.kernels import build

    fn = getattr(build.load(lib), fn_name)
    fn.restype = ctypes.c_int
    ptr = ctypes.c_void_p
    fn.argtypes = ([ptr] * len(pointers) + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_uint64, ptr])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[x.data_ptr() for x in pointers], b, h, t, dk, _DTYPES[dt], float(rate),
             int(seed), stream)
    build.check(err, fn_name)


def _check_dropout(rate: float, seed: int) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"dropout seed {seed} outside [0, 2**64)")


def _qkv(what: str, q_u, others: dict, extra=()):
    """Argument list for _check_inputs: the (B, H, T, dk) tensors share q_u's
    shape and type; extra holds (name, tensor, shape, dtype)."""
    if q_u.shape[-1] != 64:
        raise ValueError(f"{what} kernel supports head dim 64, got {q_u.shape[-1]}")
    return ([("q_u", q_u, q_u.shape, q_u.dtype)]
            + [(n, x, q_u.shape, q_u.dtype) for n, x in others.items()] + list(extra))


def rel_attention_kernel(q_u, q_v, k, v, p, mask, dropout_rate: float = 0.0, seed: int = 0):
    """Launch csrc/rel_attention.cu; returns (out (B,H,T,dk), lse (B,H,T) f32).
    Rows with no valid key stay finite (a uniform average of V). A block of
    384 threads (a TMA producer warpgroup, two consumer warpgroups on wgmma)
    owns 128 query rows in bf16, 64 in f32, where the two warpgroups take
    32 keys of each tile and combine at the end. f32 inputs take the kernel's 3xTF32 path
    (three TF32 tensor-core products for each f32 one, f32 sums), bf16 ones
    its bf16 path, which rounds P to bf16 before P V. The softmax runs in
    log2 units (exp2); the returned log-sum-exp is the natural one. Every
    pointer must be 16-byte aligned."""
    b, h, t, dk = q_u.shape
    _check_dropout(dropout_rate, seed)
    _check_inputs("rel_attention", _qkv("rel_attention", q_u, {"q_v": q_v, "k": k, "v": v},
                                        [("p", p, (h, 2 * t - 1, dk), q_u.dtype)]), mask, b, t)
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q_u.device)
    _launch("rel_attention", "l2s_rel_attention", (q_u, q_v, k, v, p, mask_u8, out, lse),
            b, h, t, dk, q_u.dtype, dropout_rate, seed, q_u.device)
    rel_attention_kernel.launches += 1
    return out, lse


rel_attention_kernel.launches = 0   # kernel launches since the last reset


def rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, lse, out, g,
                             dropout_rate: float = 0.0, seed: int = 0):
    """Launch csrc/rel_attention_bwd.cu; returns (dq_u, dq_v, dk, dv, dp) in
    the input type. lse and out come from rel_attention_kernel with the same
    dropout_rate and seed. One key-major kernel for both types: f32 inputs
    take its 3xTF32 path, bf16 ones its bf16 path, which rounds dS and P to
    bf16 as operands. It sums dq_u, dq_v and dp over key blocks by f32
    reductions into zeroed f32 buffers allocated here (rounded to bf16 after
    the launch for bf16 inputs), so their last bits may differ between runs
    in either type; dk and dv are deterministic."""
    b, h, t, dk = q_u.shape
    dev, dt = q_u.device, q_u.dtype
    _check_dropout(dropout_rate, seed)
    _check_inputs("rel_attention_bwd",
                  _qkv("rel_attention_bwd", q_u, {"q_v": q_v, "k": k, "v": v, "out": out, "g": g},
                       [("p", p, (h, 2 * t - 1, dk), dt),
                        ("lse", lse, (b, h, t), torch.float32)]), mask, b, t)
    mask_u8 = mask.to(torch.uint8).contiguous()
    dq_u, dq_v = (torch.zeros(q_u.shape, dtype=torch.float32, device=dev) for _ in range(2))
    dk_, dv = torch.empty_like(q_u), torch.empty_like(q_u)
    dp = torch.zeros((h, 2 * t - 1, dk), dtype=torch.float32, device=dev)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    _launch("rel_attention_bwd", "l2s_rel_attention_bwd",
            (q_u, q_v, k, v, p, mask_u8, lse, out, g, dq_u, dq_v, dk_, dv, dp, delta),
            b, h, t, dk, dt, dropout_rate, seed, dev)
    rel_attention_bwd_kernel.launches += 1
    return dq_u.to(dt), dq_v.to(dt), dk_, dv, dp.to(dt)


rel_attention_bwd_kernel.launches = 0   # kernel launches since the last reset


def rel_attention_bias_kernel(q_u, k, v, bias, mask, dropout_rate: float = 0.0, seed: int = 0):
    """Launch csrc/rel_attention_bias.cu; returns (out (B,H,T,dk), lse (B,H,T)
    f32). bias is (B, H, T, T) float32 whatever the type of q_u, k, v, and
    is added to the f32 scores unrounded. Rows with no valid key stay
    finite. flash_fwd_hopper.cuh's forward (a TMA producer warpgroup, two
    consumer warpgroups on wgmma) with the bias tile added to each score
    tile in log2 units: f32 inputs run both products in 3xTF32 (each operand
    split into a TF32 hi and an f32 lo), 64 query rows a block, bf16 ones in
    bf16 with P rounded to bf16 before P V, 128 rows a block. The returned
    log-sum-exp is the natural one. Deterministic."""
    b, h, t, dk = q_u.shape
    _check_dropout(dropout_rate, seed)
    _check_inputs("rel_attention_bias",
                  _qkv("rel_attention_bias", q_u, {"k": k, "v": v},
                       [("bias", bias, (b, h, t, t), torch.float32)]), mask, b, t)
    mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty_like(q_u)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q_u.device)
    _launch("rel_attention_bias", "l2s_rel_attention_bias",
            (q_u, k, v, bias, mask_u8, out, lse), b, h, t, dk, q_u.dtype, dropout_rate, seed,
            q_u.device)
    rel_attention_bias_kernel.launches += 1
    return out, lse


rel_attention_bias_kernel.launches = 0   # kernel launches since the last reset


def rel_attention_bias_bwd_kernel(q_u, k, v, bias, mask, lse, out, g,
                                  dropout_rate: float = 0.0, seed: int = 0):
    """Launch csrc/rel_attention_bias_bwd.cu; returns (dq_u, dk, dv, dbias)
    with dbias (B, H, T, T) f32, the unscaled dS. One TMA-fed key-major
    kernel for both types, a block of 64 keys (f32 inputs: every product in
    3xTF32; bf16: every product on wgmma, dS and P rounded to bf16 as
    operands). It sums dq_u over key blocks by f32
    reductions into a zeroed f32 buffer allocated here (rounded to bf16
    after the launch for bf16 inputs), so the last bits of dq_u may differ
    between runs in either type; dk, dv and dbias are deterministic."""
    b, h, t, dk = q_u.shape
    dev, dt = q_u.device, q_u.dtype
    _check_dropout(dropout_rate, seed)
    _check_inputs("rel_attention_bias_bwd",
                  _qkv("rel_attention_bias_bwd", q_u, {"k": k, "v": v, "out": out, "g": g},
                       [("bias", bias, (b, h, t, t), torch.float32),
                        ("lse", lse, (b, h, t), torch.float32)]), mask, b, t)
    mask_u8 = mask.to(torch.uint8).contiguous()
    dq_u = torch.zeros(q_u.shape, dtype=torch.float32, device=dev)
    dk_, dv = torch.empty_like(q_u), torch.empty_like(q_u)
    dbias = torch.empty_like(bias)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    _launch("rel_attention_bias_bwd", "l2s_rel_attention_bias_bwd",
            (q_u, k, v, bias, mask_u8, lse, out, g, dq_u, dk_, dv, dbias, delta),
            b, h, t, dk, dt, dropout_rate, seed, dev)
    rel_attention_bias_bwd_kernel.launches += 1
    return dq_u.to(dt), dk_, dv, dbias


rel_attention_bias_bwd_kernel.launches = 0   # kernel launches since the last reset


class RelAttentionFn(torch.autograd.Function):
    """Shear route on CUDA: forward and backward are the two kernels."""

    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, mask, rate, seed):
        out, lse = rel_attention_kernel(q_u, q_v, k, v, p, mask, rate, seed)
        ctx.save_for_backward(q_u, q_v, k, v, p, mask, lse, out)
        ctx.dropout = (rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = rel_attention_bwd_kernel(*ctx.saved_tensors, g.contiguous(), *ctx.dropout)
        return (*grads, None, None, None)


class BiasAttentionFn(torch.autograd.Function):
    """Bias route on CUDA; the bias's own gradient goes on through
    rel_position_bias by PyTorch's autograd."""

    @staticmethod
    def forward(ctx, q_u, k, v, bias, mask, rate, seed):
        out, lse = rel_attention_bias_kernel(q_u, k, v, bias, mask, rate, seed)
        ctx.save_for_backward(q_u, k, v, bias, mask, lse, out)
        ctx.dropout = (rate, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = rel_attention_bias_bwd_kernel(*ctx.saved_tensors, g.contiguous(), *ctx.dropout)
        return (*grads, None, None, None)


def rel_attention(q_u, q_v, k, v, p, mask, impl: str | None = None,
                  dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Relative-position attention, differentiable: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors. Shapes as
    dense_rel_attention. impl: "shear" or "bias" (None: LIP2SPEECH_FLASH_IMPL,
    else "shear"). With dropout_rate > 0 the probabilities are dropped under
    the mask of ops/dropout_mask.py for `seed`, on either device."""
    impl = impl or os.environ.get("LIP2SPEECH_FLASH_IMPL", "shear")
    if impl not in ("bias", "shear"):
        raise ValueError(f"unknown flash impl {impl!r} (bias|shear)")
    _check_dropout(dropout_rate, seed)
    on_cpu = q_u.device.type == "cpu"
    keep = None
    if on_cpu and dropout_rate > 0.0:
        b, h, t, _ = q_u.shape
        keep = attention_keep_mask(seed, dropout_rate, b, h, t, q_u.device)
    if impl == "shear":
        if on_cpu:
            return dense_rel_attention(q_u, q_v, k, v, p, mask, keep, dropout_rate)
        return RelAttentionFn.apply(q_u, q_v, k, v, p, mask, dropout_rate, seed)
    bias = rel_position_bias(q_v, p)
    if on_cpu:
        return dense_bias_attention(q_u, k, v, bias, mask, keep, dropout_rate)
    return BiasAttentionFn.apply(q_u, k, v, bias, mask, dropout_rate, seed)
