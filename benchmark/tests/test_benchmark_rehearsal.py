"""CPU rehearsals of every cell at the tiny size (the port's plain path):
the result line keeps to the contract, the traced run reduces its window,
and a run writes only inside the checkout and its HOME, XDG_CACHE_HOME and
TMPDIR."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, run
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "counts", "checks"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_result_line(name):
    res = tiny.rehearse(name)
    assert list(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    cell = harness.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    for k, v in res["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.limits["limits"])
    json.dumps(res)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_traced_rehearsal(name):
    """Without a card the window holds no device event: only the counters'
    metrics are read, and the device's figures are 0."""
    res = tiny.rehearse(name, trace=True, seconds=2.0)
    assert res["correct"] is True
    cell = harness.load_cell(name)
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    if cell.traffic["driver"] == "serve_closed":
        assert {"pad_share.serve", "rows_per_call.serve"} <= set(res["metrics"])
        assert 0.0 <= res["metrics"]["pad_share.serve"]["value"] < 100.0
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_exits_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          tiny.CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_exits_on_an_unknown_cell():
    assert run.main(["--workload", "no.such.cell", "--seed", "1", "--seconds", "1"]) != 0


def _tree(root):
    skip = {".git", "__pycache__", "chiprun_out", ".pytest_cache"}
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in skip]
        out |= {os.path.join(dirpath, f) for f in filenames}
    return out


def test_writes_only_where_it_may(tmp_path):
    """A rehearsal in a fresh process with HOME, XDG_CACHE_HOME and TMPDIR of
    its own adds no file to the checkout outside its caches, and nothing to
    the trace helper's default /tmp directory."""
    env = dict(os.environ, HOME=str(tmp_path / "home"), XDG_CACHE_HOME=str(tmp_path / "xdg"),
               TMPDIR=str(tmp_path / "tmp"))
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        os.makedirs(env[k])
    before = _tree(harness.ROOT)
    fixed = "/tmp/lip2speech-torch-trace"
    had = os.path.exists(fixed)
    code = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r});"
            "from benchmark.tests import tiny;"
            f"tiny.rehearse({tiny.CELLS[1]!r}, trace=True, seconds=1.0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    added = _tree(harness.ROOT) - before
    allowed = ("benchmark/_cache/", "lip2speech_tpu_torch/kernels/_build/")
    assert not [p for p in added if not any(a in p for a in allowed)]
    assert os.path.exists(fixed) == had
