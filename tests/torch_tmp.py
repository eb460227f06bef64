"""`tmp_path` for the port's tests that write checkpoints and datasets.

A test module that imports it (`from torch_tmp import tmp_path`) gets, in
place of pytest's fixture, the same per-test directory, removed at the
test's teardown when the test passed (kept when it failed, for a look).
pytest keeps every tmp_path directory until the session ends, and the suite
writes ~10 GB there: on a disk shared with other processes that filled,
torch.save of a gloo rank failed mid-write ("unexpected pos") and a
spawned rank could not leave its error file. The port's checkpoint-writing
tests wrote ~6 GB of it; with this they hold at most their own at a time.
"""

import re
import shutil

import pytest


@pytest.fixture
def tmp_path(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(re.sub(r"\W", "_", request.node.name)[:30], numbered=True)
    failed_before = request.session.testsfailed
    yield path
    if request.session.testsfailed == failed_before:
        shutil.rmtree(path, ignore_errors=True)
