"""The yardstick's arithmetic: the card's peaks, the operations and bytes of
each hand-written kernel's launch, and the model FLOPs of a request or a
training row.

A kernel's bound time is max(bytes / HBM bandwidth, operations / peak): each
input byte read once and each output byte written once, and the operations
that the call's valid rows need (keys and queries past a row's length are
not counted). f32 kernels run their products in 3xTF32 on the tensor cores,
so an f32 share is taken against the dense TF32 peak, never the 67 TFLOP/s
of the CUDA cores: the share cannot pass 100% however fast the kernel gets.

Model FLOPs count the products of the GEMMs, convolutions, transposed
convolutions and attention of the unpadded frames, as the plain reference
computes them (the relative-position term over its 2T-1 positions); no
elementwise work. A training row counts 3x its forward.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,    # dense, tensor cores
              "float32": 494.7e12}   # dense TF32, tensor cores (3xTF32 kernels)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound_s(n_bytes: float, flops: float, dtype) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name(dtype)])


def _sq_lengths(mask, b: int, t: int) -> int:
    """Sum over rows of (valid length)^2; every key valid without a mask."""
    if mask is None:
        return b * t * t
    lengths = mask.reshape(b, t).sum(1).tolist()
    return int(sum(n * n for n in lengths))


def rel_attention_work(b, h, t, dk, itemsize, mask) -> tuple[float, float]:
    """Forward: q_u q_v k v read, out written, p, mask, lse once; QK^T, the
    position term and PV over the valid rows."""
    n_bytes = 5 * b * h * t * dk * itemsize + h * (2 * t - 1) * dk * itemsize + b * t + b * h * t * 4
    return n_bytes, 3 * 2 * h * dk * _sq_lengths(mask, b, t)


def rel_attention_bwd_work(b, h, t, dk, itemsize, mask) -> tuple[float, float]:
    """Backward: q_u q_v k v out dO read and dq_u dq_v dk dv written, p and
    dp, mask, lse once; eight products over the valid rows."""
    n_bytes = (10 * b * h * t * dk * itemsize + 2 * h * (2 * t - 1) * dk * itemsize + b * t
               + b * h * t * 4)
    return n_bytes, 8 * 2 * h * dk * _sq_lengths(mask, b, t)


def attention_work(b, h, t, dk, itemsize, mask) -> tuple[float, float]:
    n_bytes = 4 * b * h * t * dk * itemsize + (b * t if mask is not None else 0)
    return n_bytes, 4 * h * dk * _sq_lengths(mask, b, t)


def trio_work(b, c, m, itemsize, weight_bytes, kernel_sizes, dilation_sizes) -> tuple[float, float]:
    """x read and the output written once, every weight and bias read once;
    two convs of C x C x k a dilation branch, every row."""
    macs_per_row = sum(2 * k * len(d) for k, d in zip(kernel_sizes, dilation_sizes))
    return 2 * b * c * m * itemsize + weight_bytes, 2 * macs_per_row * c * c * b * m


# ------------------------------------------------------------- model FLOPs

def _resnet3d(n: int) -> float:
    f = 2 * n * 44 * 44 * 64 * 5 * 7 * 7                  # stem conv3d, stride (1, 2, 2)
    s, cin = 22, 64                                         # after the max pool
    for planes, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        for blk in range(2):
            st = stride if blk == 0 else 1
            so = (s + 2 - 3) // st + 1
            f += 2 * n * so * so * planes * cin * 9 + 2 * n * so * so * planes * planes * 9
            if st != 1 or cin != planes:
                f += 2 * n * so * so * planes * cin
            s, cin = so, planes
    return f


def _avhubert(n: int, a: dict) -> float:
    d, ffn = a["dim"], a["ffn_dim"]
    f = _resnet3d(n) + 2 * n * 512 * d + 2 * n * 2 * d * d
    f += 2 * (n + 1) * d * (d // 16) * 128                  # grouped positional conv, k 128
    return f + a["layers"] * (4 * 2 * n * d * d + 2 * 2 * n * n * d + 2 * 2 * n * d * ffn)


def _conformer(t: int, c: dict) -> float:
    d, ffn = c["dim"], c["ffn_dim"]
    per = (2 * 2 * 2 * t * d * ffn                          # two FFNs
           + 4 * 2 * t * d * d + 2 * (2 * t - 1) * d * d     # q k v out, the position projection
           + 2 * t * t * d + 2 * t * (2 * t - 1) * d + 2 * t * t * d   # QK^T, position term, PV
           + 2 * t * d * 2 * d + 2 * t * d * c["conv_kernel"] + 2 * t * d * d)  # conv module
    return 2 * t * c["input_dim"] * d + c["layers"] * per


def stage1_flops(arch: dict, n: int) -> float:
    """One row of n frames through stage 1 (frontend, conformer, heads)."""
    c = arch["conformer"]
    d, t = c["dim"], 2 * n
    f = _avhubert(n, arch["avhubert"]) if arch["frontend"] == "avhubert" else _resnet3d(n)
    f += _conformer(t, c)
    f += 2 * t * (arch["spk_dim"] + d) * d * 3 + 2 * 2 * t * d * d * 3 + 2 * t * d * 2 * arch["mel_dim"]
    return f + 2 * 2 * t * d * d + 2 * t * d * arch["vocab"]


def vocoder_flops(v: dict, n: int) -> float:
    """One row of n frames (2n units, 4n mel frames) through the vocoder."""
    tc, e = 2 * n, v["embedding_dim"]
    f = 2 * tc * 4 * e * e + 2 * 2 * tc * e * e + 2 * v["embedder_dim"] * e
    m, ch = 4 * n, v["upsample_initial_channel"]
    f += 2 * m * v["model_in_dim"] * ch * 7
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        f += 2 * m * k * ch * (ch // 2)
        ch //= 2
        m *= u
        for rk, rd in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
            f += len(rd) * 2 * (2 * m * ch * ch * rk)
    return f + 2 * m * ch * 7


def request_flops(arch: dict, n: int) -> float:
    return stage1_flops(arch, n) + vocoder_flops(arch["vocoder"], n)


def train_row_flops(arch: dict, n: int) -> float:
    return 3 * stage1_flops(arch, n)


# ------------------------------------------- launch records (trace runs)

def rel_attention_shapes(args) -> tuple:
    """rel_attention_kernel / rel_attention_bwd_kernel(q_u, q_v, k, v, p, mask, ...)."""
    q = args[0]
    return tuple(q.shape), q.element_size(), dtype_name(q.dtype), args[5]


def attention_shapes(args) -> tuple:
    """attention_kernel(q, k, v, mask=None)."""
    q = args[0]
    return tuple(q.shape), q.element_size(), dtype_name(q.dtype), args[3] if len(args) > 3 else None


def trio_shapes(args) -> tuple:
    """fused_resblock_trio_kernel(x, weights, kernel_sizes, dilation_sizes)."""
    x, weights, ks, ds = args[:4]
    n_w = sum(w.numel() + bb.numel() for rb in weights for pair in rb for w, bb in pair)
    return tuple(x.shape), x.element_size(), dtype_name(x.dtype), n_w * x.element_size(), ks, ds
