"""The control: the reference's comparison run on the port's own bfloat16
path, the step below the configuration's float32, must come out not
correct, at a size the CPU holds. (On the card at each cell's own size:
benchmark/control.py, whose readings PERF.md gives beside each limit.)"""

import pytest

from benchmark.tests import tiny


def _all(name):
    """Serving: compare every request completed, not a sample."""
    return {"checked": 10 ** 6} if ".serve." in name else {}


@pytest.mark.parametrize("name", tiny.CELLS)
def test_bfloat16_control_is_not_correct(name):
    res = tiny.rehearse(name, dtype="bfloat16", traffic=_all(name))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_float32_program_is_correct(name):
    res = tiny.rehearse(name, traffic=_all(name))
    assert res["correct"] is True, res["checks"]
