"""Share of its roofline of the relative-position attention forward
(ops/rel_attention.py -> csrc/rel_attention.cu) in the training step (forward with dropout)."""

from benchmark import readers, work

KERNEL = "rel_attention"
LAUNCH = ("lip2speech_tpu_torch.ops.rel_attention", "rel_attention_kernel", work.rel_attention_shapes)
PATTERN = r"(?<![a-z_])rel_attention_wgmma"


def work_of(rec):
    (b, h, t, dk), size, dtype, mask = rec
    return (*work.rel_attention_work(b, h, t, dk, size, mask), dtype)


def read(view):
    return readers.roofline(view, KERNEL, PATTERN, work_of)
