"""Share of its roofline of the vocoder's resblock-trio kernel
(ops/fused_tail.py -> csrc/fused_tail.cu) in the serving calls."""

from benchmark import readers, work

KERNEL = "fused_tail"
LAUNCH = ("lip2speech_tpu_torch.ops.fused_tail", "fused_resblock_trio_kernel", work.trio_shapes)
PATTERN = r"(?<![a-z_])trio_wgmma"


def work_of(rec):
    (b, c, m), size, dtype, wbytes, ks, ds = rec
    return (*work.trio_work(b, c, m, size, wbytes, ks, ds), dtype)


def read(view):
    return readers.roofline(view, KERNEL, PATTERN, work_of)
