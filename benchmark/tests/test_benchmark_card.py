"""On the card: one short run of each cell through the command of
BENCHMARK.json, whose last line must be a correct result on the card.
Marked `card`; skips without CUDA. Run on the card machine with

    python3 -m pytest benchmark/tests/test_benchmark_card.py -m card
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.CELLS)
def test_short_run_on_the_card(card, name):
    cmd = harness.load_json(harness.ROOT / "BENCHMARK.json")["command"]
    out = subprocess.run([sys.executable, *cmd[1:], "--workload", name, "--seed", str(2 ** 31 + 9),
                          "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
