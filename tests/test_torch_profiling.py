"""The port's profiling helpers (lip2speech_tpu_torch/utils/profiling.py)
against the JAX package's copies: StageTimer's report and dump keys, counts
and JSON layout, TokensPerSecond's count; device_trace on the CPU writes a
Chrome trace into the directory given, holding the annotate ranges."""

import json
import time

from lip2speech_tpu.utils import profiling as jprof
from lip2speech_tpu_torch.utils import profiling as tprof

import torch


def _staged(timer):
    for name, n in (("encode", 3), ("decode", 1), ("vocode", 2)):
        for _ in range(n):
            with timer.stage(name):
                time.sleep(0.001)
    return timer


def test_stage_timer_matches_jax(tmp_path):
    got, ref = _staged(tprof.StageTimer()), _staged(jprof.StageTimer())
    g, r = got.report(), ref.report()
    assert list(g) == list(r) == ["decode", "encode", "vocode"]
    for k in r:
        assert list(g[k]) == list(r[k]) == ["total_s", "count", "mean_s"]
        assert g[k]["count"] == r[k]["count"]
        assert g[k]["total_s"] >= 0.001 * g[k]["count"]
    got.dump(tmp_path / "t.json")
    ref.dump(tmp_path / "j.json")
    loaded = json.loads((tmp_path / "t.json").read_text())
    assert loaded == g
    assert (tmp_path / "t.json").read_text().count("\n") == (tmp_path / "j.json").read_text().count("\n")


def test_stage_timer_counts_a_stage_that_raises():
    timer = tprof.StageTimer()
    try:
        with timer.stage("bad"):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    assert timer.report()["bad"]["count"] == 1


def test_tokens_per_second_matches_jax():
    got, ref = tprof.TokensPerSecond(), jprof.TokensPerSecond()
    for n in (10, 20, 30):
        got.update(n)
        ref.update(n)
    assert got.n == ref.n == 60
    assert got.avg > 0 and ref.avg > 0


def test_device_trace_holds_the_annotated_ranges(tmp_path):
    logdir = tmp_path / "trace"
    x = torch.randn(16, 16)
    with tprof.device_trace(logdir):
        for name in ("forward", "loss", "backward"):
            with tprof.annotate(name):
                x = x @ x.T / 16
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert {"forward", "loss", "backward"} <= names
    assert any(n and "mm" in n for n in names)
