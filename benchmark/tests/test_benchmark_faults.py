"""A run whose timed path is broken underneath comes out not correct: each
fault a cell can have (benchmark/faults.py), planted in the port at the tiny
size on the CPU and driven through the rest of a run (the card's look
skipped). One card, so no exchange between cards to leave out."""

import pytest

from benchmark import faults
from benchmark.tests import tiny

SERVE = [n for n in tiny.CELLS if ".serve." in n]
TRAIN = [n for n in tiny.CELLS if ".train." in n]


@pytest.mark.parametrize("fault", sorted(faults.PIPELINE))
@pytest.mark.parametrize("name", SERVE)
def test_serving_fault_is_caught(name, fault):
    # every request completed is compared: a fault in some rows only shows
    res = tiny.rehearse(name, hooks={"pipeline": [faults.PIPELINE[fault]]},
                        traffic={"checked": 10 ** 6})
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN_STEP))
@pytest.mark.parametrize("name", TRAIN)
def test_training_fault_is_caught(name, fault):
    res = tiny.rehearse(name, hooks={"train_step": [faults.TRAIN_STEP[fault]]})
    assert res["correct"] is False, res["checks"]
