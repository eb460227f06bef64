"""The reduction from a profiler window to the per-layer metrics, on
synthetic spans (microseconds on the window's clock)."""

import pytest

from benchmark import readers, trace
from benchmark.trace import Span, View


def _view(**kw):
    device = [Span("spin_kernel(long)", 0, 1), Span("gemm_a", 10, 30), Span("trio_wgmma<float, 128>", 30, 50),
              Span("spin_kernel(long)", 60, 61), Span("trio_wgmma<float, 64>", 70, 90),
              Span("spin_kernel(long)", 95, 96), Span("Memcpy HtoD", 200, 300)]
    args = dict(window_s=400e-6, device=device, host=[Span("cudaStreamSynchronize", 100, 200)],
                gpu_ranges={}, markers=(r"spin_kernel", (trace.STAGE1, trace.VOCODER, None)))
    args.update(kw)
    return View(**args)


def test_busy_and_kernel_time():
    v = _view()
    assert v.busy_s == pytest.approx((1 + 40 + 1 + 20 + 1 + 100) * 1e-6)
    assert v.kernel_s(r"(?<![a-z_])trio_wgmma") == pytest.approx(40e-6)
    assert readers.idle_share(v) == pytest.approx(100 * (1 - 163 / 400))


def test_ranges_from_markers_and_device_spans():
    v = _view()
    assert v.range_device_s(trace.STAGE1) == pytest.approx(40e-6)
    assert v.range_device_s(trace.VOCODER) == pytest.approx(20e-6)
    assert v.range_device_s("Optimizer.step#AdamW.step") is None
    v = _view(markers=None, gpu_ranges={"Optimizer.step#AdamW.step": [Span("x", 65, 92)]})
    assert v.range_device_s("Optimizer.step#AdamW.step") == pytest.approx(20e-6)
    # a window cut inside a call (markers not whole) reads nothing
    v = _view(device=_view().device[:4])
    assert v.range_device_s(trace.STAGE1) is None


def test_breakdown_names_gaps_by_host_activity():
    v = _view(host_marks=[Span(trace.CALL, 0, 150)])
    b = trace.breakdown(v)
    assert b["device_ops"][0] == ["Memcpy HtoD", pytest.approx(100e-6)]
    assert b["idle_gaps"][:2] == [["bench.device_call > cudaStreamSynchronize", pytest.approx(104e-6)],
                                  ["between device calls", pytest.approx(100e-6)]]


def test_roofline_left_out_when_launches_disagree(capsys):
    rec = [(1.0e6, 1.0e9, "float32")]
    v = _view(work={"k": rec}, launches={"k": 2})
    assert readers.roofline(v, "k", "gemm_a", lambda r: r) is None
    assert "left out" in capsys.readouterr().err
    v = _view(work={"k": rec}, launches={"k": 1})
    share = readers.roofline(v, "k", "gemm_a", lambda r: r)
    assert share == pytest.approx(100 * max(1e6 / 3.35e12, 1e9 / 494.7e12) / 20e-6)
    assert readers.roofline(v, "k", "nothing_runs", lambda r: r) is None


def test_mfu_and_per_speech():
    v = _view(model_flops=494.7e12 * 400e-6 * 0.05, speech_s=2.0)
    assert readers.mfu(v) == pytest.approx(5.0)
    assert readers.per_speech_s(v, trace.STAGE1) == pytest.approx(1e3 * 40e-6 / 2.0)
