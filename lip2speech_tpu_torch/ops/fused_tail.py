"""Fused HiFi-GAN resblock trio (JAX reference: ops/pallas_fused_tail.py,
`_fused_forward`'s `kernel`, entry `fused_resblock_trio`).

One vocoder stage runs several ResBlock1 modules (kernels 3/7/11, each with
dilation branches 1/3/5 of lrelu -> dilated conv -> lrelu -> conv ->
residual add) over the same input and averages them: 18 convs at the default
config. The CUDA kernel (csrc/fused_tail.cu) runs the whole trio for one row
tile plus its halo out of shared memory, every conv on wgmma in both dtypes:
the activations as register fragments at any tap shift, the weights from a
TMA-fed shared-memory ring (`pack_weights` lays them out as it streams
them); f32 in 3xTF32 (each operand split into two TF32 parts, three
products: f32 accuracy). `trio_plain` is its plain version. Unlike the TPU
kernel the port does not fold channels into 128 lanes: activations stay in
PyTorch's (B, C, M) conv layout.

Under grad the kernel runs inside `TrioFn`, whose backward recomputes the
plain version (the bare kernel refuses inputs that require grad).

Semantics both versions hold: every conv output outside the true sequence
[0, M) is zero (each conv zero-pads its own input), the bias is added after
the cast to the activation dtype, and the sum is divided by the number of
resblocks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from lip2speech_tpu_torch.ops import nn as ops

LRELU_SLOPE = 0.1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448         # dynamic shared memory a block may take on Hopper
MAX_RES, MAX_DIL = 4, 4      # geometry table size of csrc/fused_tail.cu
# csrc/fused_tail.cu's weight ring (kSlotBytes, kStages), its barriers and
# alignment slack (kBarBytes, kAlign), its consumer warpgroups (kConsumers)
RING_SLOT, BAR_BYTES, ALIGN, WARPGROUPS = 16_384, 256, 1024, 2
RING_STAGES = {torch.bfloat16: 4, torch.float32: 3}
# csrc/fused_tail.cu's Cfg per dtype and C: m64 tiles a consumer warpgroup
# holds a round, bytes of a weight panel row (128- or 64-byte swizzle)
LAYOUTS = {
    torch.bfloat16: {128: (2, 128), 64: (4, 128), 32: (4, 128), 16: (4, 128)},
    torch.float32: {128: (1, 64), 64: (2, 128), 32: (2, 128), 16: (2, 128)},
}


def _cfg(channels: int, dtype: torch.dtype) -> dict:
    """csrc/fused_tail.cu's Cfg<T, C>: bytes of a weight panel row (rb), its
    k (pw) and a wgmma's (ks), 16-byte chunk elements (e), rows of a panel
    (ns: C, or 2C where f32 stacks each output's hi and lo parts, at C =
    16), panels a ring chunk (pps), m64 tiles a warpgroup holds (mt)."""
    es = 4 if dtype == torch.float32 else 2
    mt, rb = LAYOUTS[dtype][channels]
    stack = dtype == torch.float32 and channels == 16
    ns = 2 * channels if stack else channels
    parts = 2 if dtype == torch.float32 and not stack else 1
    return {"es": es, "e": 16 // es, "rb": rb, "pw": rb // es, "ks": 8 if es == 4 else 16,
            "stack": stack, "ns": ns, "pps": RING_SLOT // (parts * ns * rb), "mt": mt}


def resblock1_plain(x: torch.Tensor, branches, kernel: int,
                    dilations: Sequence[int]) -> torch.Tensor:
    """One ResBlock1. branches: per dilation ((w1, b1), (w2, b2)), w in
    torch layout (C, C, K)."""
    for ((w1, b1), (w2, b2)), d in zip(branches, dilations):
        pad1, pad2 = ops.branch_paddings(kernel, d)
        xt = ops.conv1d(ops.leaky_relu(x, LRELU_SLOPE), w1, b1, padding=pad1, dilation=d)
        xt = ops.conv1d(ops.leaky_relu(xt, LRELU_SLOPE), w2, b2, padding=pad2)
        x = x + xt
    return x


def trio_plain(x: torch.Tensor, weights, kernel_sizes: Sequence[int],
               dilation_sizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """Plain version: the mean of the ResBlock1 outputs. x (B, C, M);
    weights: per resblock, per dilation branch, ((w1, b1), (w2, b2))."""
    acc = None
    for rb, k, dils in zip(weights, kernel_sizes, dilation_sizes):
        y = resblock1_plain(x, rb, k, dils)
        acc = y if acc is None else acc + y
    return acc / len(weights)


def _geometry(kernel_sizes, dilation_sizes) -> tuple[list[int], int]:
    """Flat int table for the kernel and the chain halo H (rows each side
    a tile needs: the largest sum of a resblock's conv paddings)."""
    n_res, n_dil = len(kernel_sizes), len(dilation_sizes[0])
    if n_res > MAX_RES or n_dil > MAX_DIL or any(len(d) != n_dil for d in dilation_sizes):
        raise ValueError(f"fused trio supports up to {MAX_RES} resblocks of "
                         f"{MAX_DIL} equal-length dilation lists")
    ks = [0] * MAX_RES
    dil, pad1, pad2 = ([0] * (MAX_RES * MAX_DIL) for _ in range(3))
    halo = 0
    for r, (k, dils) in enumerate(zip(kernel_sizes, dilation_sizes)):
        ks[r] = k
        chain = 0
        for i, d in enumerate(dils):
            p1, p2 = ops.branch_paddings(k, d)
            dil[r * MAX_DIL + i], pad1[r * MAX_DIL + i], pad2[r * MAX_DIL + i] = d, p1, p2
            chain += p1 + p2
        halo = max(halo, chain)
    return [n_res, n_dil, halo] + ks + dil + pad1 + pad2, halo


def xt_trim(kernel_sizes, dilation_sizes, halo: int) -> int:
    """Rows the conv1 output buffer leaves out on each side: the first row
    any conv1 writes (csrc/fused_tail.cu: conv_table's xt_off)."""
    trim = halo
    for k, dils in zip(kernel_sizes, dilation_sizes):
        pads = [ops.branch_paddings(k, d) for d in dils]
        lo = halo - sum(p1 + p2 for p1, p2 in pads)
        for p1, p2 in pads:
            trim = min(trim, lo + p1)
            lo += p1 + p2
    return trim


def smem_bytes(channels: int, dtype: torch.dtype, tile: int, halo: int, trim: int = 0) -> int:
    """Shared memory of one block as csrc/fused_tail.cu lays it out: the
    weight ring (RING_STAGES[dtype] slots of RING_SLOT bytes), the residual
    buffer of tile + 2*halo rows and the conv1 output buffer, 2*trim rows
    fewer, both row-major [rows][C], the ring's barriers and the slack that
    aligns the base to 1024 bytes."""
    es = 4 if dtype == torch.float32 else 2
    return (ALIGN + RING_STAGES[dtype] * RING_SLOT + BAR_BYTES
            + (2 * (tile + 2 * halo) - 2 * trim) * channels * es)


def conv_regions(kernel_sizes, dilation_sizes, tile: int) -> list[tuple[int, int]]:
    """(taps, output rows) of every conv of the trio for one block, in
    launch order: each conv computes only the rows the rest of its chain
    needs (csrc/fused_tail.cu: conv_table)."""
    regions = []
    for k, dils in zip(kernel_sizes, dilation_sizes):
        pads = [ops.branch_paddings(k, d) for d in dils]
        rest = sum(p1 + p2 for p1, p2 in pads)
        for p1, p2 in pads:
            regions.append((k, tile + 2 * (rest - p1)))
            regions.append((k, tile + 2 * (rest - p1 - p2)))
            rest -= p1 + p2
    return regions


def block_cost(channels: int, regions, dtype: torch.dtype = torch.bfloat16) -> int:
    """A block's work in wgmma k-steps of its busiest consumer warpgroup:
    per conv, its k-steps times, per round, the m64 tiles that warpgroup
    holds (the tiles alternate between the two; a round that fills few
    tiles costs as many steps)."""
    cfg = _cfg(channels, dtype)
    cost = 0
    for k, rows in regions:
        tiles = -(-rows // 64)
        steps = k * channels // cfg["ks"]
        while tiles > 0:
            in_round = min(tiles, WARPGROUPS * cfg["mt"])
            cost += steps * -(-in_round // WARPGROUPS)
            tiles -= in_round
    return cost


@functools.lru_cache(maxsize=256)
def tile_rows(channels: int, dtype: torch.dtype, halo: int, m: int, batch: int = 1,
              n_sm: int = 132, kernel_sizes: tuple = (3, 7, 11),
              dilation_sizes: tuple = ((1, 3, 5),) * 3) -> int:
    """Output rows per block whose buffers fit SMEM_LIMIT, one block per SM
    in both dtypes: an even tile from 32 (or the sequence, if shorter) up
    to what fits or the sequence needs. For each number of waves the
    smallest such tile does the least work a block (block_cost grows with
    the tile), so of those the one with the least waves x block_cost wins;
    ties go to the fewer waves. Small tiles fill the card, large ones
    recompute less halo, and a tile whose regions fill whole rounds wastes
    no tiles."""
    trim = xt_trim(kernel_sizes, dilation_sizes, halo)
    row_bytes = (smem_bytes(channels, dtype, 1, halo, trim)
                 - smem_bytes(channels, dtype, 0, halo, trim))
    most = (SMEM_LIMIT - smem_bytes(channels, dtype, 0, halo, trim)) // row_bytes
    need = m + m % 2
    fits = list(range(min(32, need), min(need, most - most % 2) + 1, 2))
    if not fits:
        raise ValueError(f"fused trio: halo {halo} leaves no room for a tile "
                         f"at {channels} channels")

    def cost(t):
        return block_cost(channels, conv_regions(kernel_sizes, dilation_sizes, t), dtype)

    smallest = {}                                   # waves -> smallest tile
    for t in reversed(fits):
        smallest[-(-batch * -(-m // t) // n_sm)] = t
    floor, best = cost(fits[0]), None               # no block costs less than the smallest tile's
    for waves in sorted(smallest):
        if best is not None and waves * floor > best[0]:
            break
        if best is None or waves * cost(smallest[waves]) < best[0]:
            best = (waves * cost(smallest[waves]), smallest[waves])
    return best[1]


@functools.lru_cache(maxsize=64)
def _pack_index(channels: int, dtype: torch.dtype, taps: tuple,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Where each element of the packed weight stream comes from, on
    `device`: an index into the convs' (C_out, C_in, K) weights laid end to
    end, or one past them (a zero) where a conv's last panel runs past K
    C_in. A stacked panel holds every output twice (rows r and C + r); for
    it also a mask of the lo rows (its second C rows), else None."""
    c, cfg = channels, _cfg(channels, dtype)
    e, pw, ns, cpr = cfg["e"], cfg["pw"], cfg["ns"], cfg["rb"] // 16
    total = sum(c * c * k for k in taps)
    r = torch.arange(ns).view(1, ns, 1, 1)          # panel row: output r % C
    u = torch.arange(cpr).view(1, 1, cpr, 1)        # 16-byte chunk of the row as stored
    el = torch.arange(e).view(1, 1, 1, e)
    swz = r % 8 if cpr == 8 else (r // 2) % 4       # the 128- or 64-byte swizzle
    parts, base = [], 0
    for k in taps:
        p = torch.arange(-(-k * c // pw)).view(-1, 1, 1, 1)
        kk = p * pw + (u ^ swz) * e + el             # the chunk holds k-chunk u ^ swz
        idx = base + (r % c) * (c * k) + (kk % c) * k + kk // c
        parts.append(torch.where(kk < k * c, idx, total).reshape(-1))
        base += c * c * k
    index = torch.cat(parts)
    lo_rows = (torch.arange(index.numel()) // (pw * c)) % 2 == 1 if cfg["stack"] else None
    return index.to(device), None if lo_rows is None else lo_rows.to(device)


def pack_weights(ws, channels: int, dtype: torch.dtype) -> torch.Tensor:
    """Every conv's (C_out, C_in, K) weights, in launch order, as the
    kernel's weight ring streams them, in `dtype`: per conv, per panel p, ns
    rows (outputs) of rb bytes (128, or 64 for f32 at C = 128) holding k =
    p pw .. p pw + pw - 1 of k = tap C_in + c_in (zero past K C_in), the
    row's 16-byte chunks XOR-ed as the 128-byte swizzle (with r % 8) or the
    64-byte one (with r / 2 % 4) does: a swizzled K-major wgmma operand,
    which a TMA bulk copy moves as it is. f32 splits each value for 3xTF32
    into hi = v rounded to TF32 (as cvt.rna.tf32.f32 rounds) and lo = v -
    hi: at C = 16 a panel's first C rows hold hi and its last C rows lo;
    above, the stream comes twice, hi then lo. Launches: the concatenation
    and one gather (and the cast); f32 three or four more."""
    idx, lo_rows = _pack_index(channels, dtype, tuple(w.shape[2] for w in ws), ws[0].device)
    flat = torch.cat([w.reshape(-1) for w in ws] + [ws[0].new_zeros(1)])
    packed = flat.to(dtype)[idx]
    if dtype != torch.float32:
        return packed
    if lo_rows is not None:
        hi = ((packed.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(lo_rows, packed - hi, hi)
    out = torch.empty(2 * packed.numel(), dtype=dtype, device=packed.device)
    hi = out[:packed.numel()].view(torch.int32)
    torch.add(packed.view(torch.int32), 0x1000, out=hi)
    hi.bitwise_and_(-0x2000)
    torch.sub(packed, out[:packed.numel()], out=out[packed.numel():])
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _flat(weights) -> list[torch.Tensor]:
    return [t for rb in weights for pair in rb for wb in pair for t in wb]


def _nesting(weights) -> tuple:
    """Dilation branches per resblock (each branch two (w, b) convs)."""
    return tuple(len(rb) for rb in weights)


def _nest(flat, nesting):
    """The flat tensors back in the nesting of the weights."""
    it = iter(flat)
    return [[tuple((next(it), next(it)) for _ in range(2)) for _ in range(n)] for n in nesting]


def _needs_grad(x, weights) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad
                                                               for t in _flat(weights)))


def fused_resblock_trio_kernel(x, weights, kernel_sizes, dilation_sizes):
    """Launch csrc/fused_tail.cu on x (B, C, M) with C in {16, 32, 64, 128}.
    The result has no autograd history, so an input that would want a
    gradient is refused: under grad, go through fused_resblock_trio."""
    from lip2speech_tpu_torch.kernels import build

    if _needs_grad(x, weights):
        raise RuntimeError("fused_resblock_trio_kernel has no gradient: call "
                           "fused_resblock_trio (TrioFn) when an input requires grad")
    b, c, m = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_trio_kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused trio: dtype {x.dtype} not supported (f32, bf16)")
    if c not in (16, 32, 64, 128):
        raise ValueError(f"fused trio kernel supports 16/32/64/128 channels, got {c}")
    if not x.is_contiguous():
        raise ValueError("fused trio: x must be contiguous")
    geom, halo = _geometry(kernel_sizes, dilation_sizes)
    w_parts, b_parts = [], []
    for rb, k, dils in zip(weights, kernel_sizes, dilation_sizes):
        if len(rb) != len(dils):
            raise ValueError("fused trio: one ((w1, b1), (w2, b2)) per dilation")
        for pair in rb:
            for w, bias in pair:
                if w.shape != (c, c, k) or bias.shape != (c,):
                    raise ValueError(f"fused trio: weight {tuple(w.shape)} / bias "
                                     f"{tuple(bias.shape)}, expected {(c, c, k)} / {(c,)}")
                if w.device != x.device or bias.device != x.device:
                    raise ValueError("fused trio: weights must be on x's device")
                w_parts.append(w)
                b_parts.append(bias)
    w_all = pack_weights(w_parts, c, x.dtype)
    b_all = torch.stack(b_parts).to(x.dtype).contiguous()
    tile = tile_rows(c, x.dtype, halo, m, b, _sm_count(x.device), tuple(kernel_sizes),
                     tuple(tuple(d) for d in dilation_sizes))
    out = torch.empty_like(x)
    geom_arr = (ctypes.c_int * len(geom))(*geom)
    fn = build.load("fused_tail").l2s_resblock_trio
    fn.restype = ctypes.c_int
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 4 + [ctypes.c_int] * 5 + [ptr, ptr]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_all.data_ptr(), b_all.data_ptr(), out.data_ptr(),
             b, c, m, _DTYPES[x.dtype], tile, ctypes.cast(geom_arr, ptr), stream)
    build.check(err, "l2s_resblock_trio")
    fused_resblock_trio_kernel.launches += 1
    return out


fused_resblock_trio_kernel.launches = 0   # kernel launches since the last reset


class TrioFn(torch.autograd.Function):
    """The kernel's forward with the gradient of a plain recompute (JAX
    reference: the custom_vjp of pallas_fused_tail.fused_resblock_trio):
    the forward saves x and the composed weights; the backward runs
    trio_plain on them under autograd and returns its gradients for x and
    every (w, b), which flow on into weight_v / weight_g through the
    weight-norm composition. Arguments: x, kernel_sizes, dilation_sizes,
    the branches per resblock (_nesting), then the weights flat."""

    @staticmethod
    def forward(ctx, x, kernel_sizes, dilation_sizes, nesting, *flat):
        weights = _nest(flat, nesting)
        ctx.save_for_backward(x, *flat)
        ctx.geometry = (kernel_sizes, dilation_sizes, nesting)
        return fused_resblock_trio_kernel(x, weights, kernel_sizes, dilation_sizes)

    @staticmethod
    def backward(ctx, grad_out):
        x, *flat = ctx.saved_tensors
        kernel_sizes, dilation_sizes, nesting = ctx.geometry
        inputs = [t.detach().requires_grad_() for t in (x, *flat)]
        with torch.enable_grad():
            out = trio_plain(inputs[0], _nest(inputs[1:], nesting), kernel_sizes,
                             dilation_sizes)
            grads = torch.autograd.grad(out, inputs, grad_out)
        return (grads[0], None, None, None, *grads[1:])


def fused_resblock_trio(x, weights, kernel_sizes, dilation_sizes) -> torch.Tensor:
    """Mean of the stage's ResBlock1 outputs, x (B, C, M): the plain version
    for CPU tensors; for CUDA tensors the kernel, through TrioFn when grad is
    enabled and an input requires it."""
    if x.device.type == "cpu":
        return trio_plain(x, weights, kernel_sizes, dilation_sizes)
    if _needs_grad(x, weights):
        return TrioFn.apply(x, tuple(kernel_sizes), tuple(tuple(d) for d in dilation_sizes),
                            _nesting(weights), *_flat(weights))
    return fused_resblock_trio_kernel(x, weights, kernel_sizes, dilation_sizes)
