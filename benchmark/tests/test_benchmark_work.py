"""The yardstick's arithmetic: model FLOPs against FlopCounterMode on the
plain reference, kernel bounds against the figures of the port's own
kernel measurements (PERF.md's kernel table), f32 against the TF32 peak."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, work
from benchmark.reference import stage1, vocoder
from benchmark.tests import tiny


def _ms(n_bytes, flops, dtype):
    return work.bound_s(n_bytes, flops, dtype) * 1e3


def _full(b, t):
    return torch.ones(b, t, dtype=torch.bool)


def test_bf16_bounds_match_the_kernel_table():
    # rel_attention B4 H8 T480 ragged (bytes), B8 H8 T1200 (operations)
    lens = torch.tensor([480, 400, 300, 194])
    ragged = torch.arange(480)[None] < lens[:, None]
    assert round(_ms(*work.rel_attention_work(4, 8, 480, 64, 2, ragged), "bfloat16"), 4) == 0.0032
    assert round(_ms(*work.rel_attention_work(8, 8, 1200, 64, 2, _full(8, 1200)), "bfloat16"), 4) == 0.0358
    # the backward at B8 H8 T1200 and B4 H8 T480
    assert round(_ms(*work.rel_attention_bwd_work(8, 8, 1200, 64, 2, None), "bfloat16"), 4) == 0.0954
    assert round(_ms(*work.rel_attention_bwd_work(4, 8, 480, 64, 2, None), "bfloat16"), 4) == 0.0076
    # attention B8 H16 T600 and B1 H12 T4999
    assert round(_ms(*work.attention_work(8, 16, 600, 64, 2, _full(8, 600)), "bfloat16"), 4) == 0.0119
    assert round(_ms(*work.attention_work(1, 12, 4999, 64, 2, None), "bfloat16"), 4) == 0.0776
    # the trio's C128 stage at B4 x 240 (M 19,200 a row): 0.321 ms
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    wbytes = sum(2 * 3 * (128 * 128 * k + 128) * 2 for k in ks)
    assert round(_ms(*work.trio_work(4, 128, 19200, 2, wbytes, ks, ds), "bfloat16"), 3) == 0.321


def test_f32_bounds_take_the_tf32_peak():
    """The table's 3xTF32 bounds are 3 x operations / 494.7 TFLOP/s: the f32
    share is one third of that, never operations / 67 TFLOP/s."""
    b = _ms(*work.rel_attention_work(8, 8, 1200, 64, 4, None), "float32")
    assert round(3 * b, 4) == 0.2146
    assert b < 0.5282 / 5                         # the FMA bound chip_smoke used
    assert round(3 * _ms(*work.rel_attention_bwd_work(8, 8, 1200, 64, 4, None), "float32"), 4) == 0.5723
    assert round(3 * _ms(*work.attention_work(1, 12, 4999, 64, 4, None), "float32"), 4) == 0.4656
    assert work.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 494.7e12}


def test_masks_count_only_valid_rows():
    mask = torch.arange(100)[None] < torch.tensor([100, 50])[:, None]
    _, flops = work.attention_work(2, 4, 100, 64, 4, mask)
    assert flops == 4 * 4 * 64 * (100 ** 2 + 50 ** 2)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("config", ["multi_target", "multi_target_avhubert"])
def test_model_flops_match_the_reference(config):
    cell, overrides = tiny.cell("multi_target_avhubert.serve.long.f32", config)
    arch = cell.config["arch"]
    cfg = harness.port_config(cell.config, overrides)
    s1, voc = harness.make_weights(cfg, 7, "cpu")
    n = 5
    video = torch.randn(1, n, 88, 88, 1)
    mask, spk = _full(1, n), torch.randn(1, 256)
    assert _counted(lambda: stage1.forward(s1, arch, video, mask, spk)) == work.stage1_flops(arch, n)
    code = torch.randint(0, 200, (1, 2 * n))
    mel = torch.randn(1, 4 * n, 80)
    assert _counted(lambda: vocoder.generate(voc, arch["vocoder"], code, mel, spk)) == \
        work.vocoder_flops(arch["vocoder"], n)


def test_training_row_counts_three_forwards():
    arch = harness.load_json(harness.HERE / "configs" / "multi_target.json")["arch"]
    assert work.train_row_flops(arch, 540) == 3 * work.stage1_flops(arch, 540)
    # the published widths: ~1.06 GFLOP a frame of stage 1, ~0.99 of the vocoder
    assert 0.9e9 < work.stage1_flops(arch, 540) / 540 < 1.2e9
    assert 0.9e9 < work.vocoder_flops(arch["vocoder"], 540) / 540 < 1.1e9
    assert np.isclose(work.request_flops(arch, 100),
                      work.stage1_flops(arch, 100) + work.vocoder_flops(arch["vocoder"], 100))
