"""Share of its roofline of the relative-position attention backward
(csrc/rel_attention_bwd.cu) in the training step."""

from benchmark import readers, work

KERNEL = "rel_attention_bwd"
LAUNCH = ("lip2speech_tpu_torch.ops.rel_attention", "rel_attention_bwd_kernel",
          work.rel_attention_shapes)
PATTERN = r"(?<![a-z_])rel_bwd_wgmma"


def work_of(rec):
    (b, h, t, dk), size, dtype, mask = rec
    return (*work.rel_attention_bwd_work(b, h, t, dk, size, mask), dtype)


def read(view):
    return readers.roofline(view, KERNEL, PATTERN, work_of)
