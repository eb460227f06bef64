"""Share of its roofline of the masked attention forward of the AV-HuBERT
trunk (ops/attention.py -> csrc/attention.cu) in the serving calls."""

from benchmark import readers, work

KERNEL = "attention"
LAUNCH = ("lip2speech_tpu_torch.ops.attention", "attention_kernel", work.attention_shapes)
PATTERN = r"(?<![a-z_])attention_wgmma"


def work_of(rec):
    (b, h, t, dk), size, dtype, mask = rec
    return (*work.attention_work(b, h, t, dk, size, mask), dtype)


def read(view):
    return readers.roofline(view, KERNEL, PATTERN, work_of)
