"""The port's capacity probe (lip2speech_tpu_torch/cli/find_max_duration.py)
against the JAX package's on the CPU at the tiny preset: the probe list (the
seconds, frames and ok of each probe), one probe's waveform from the JAX
random weights carried across (within 1e-4 of max |ref|), and the end of the
list: an out-of-memory error ends it, any other error raises."""

import json
import sys

import numpy as np
import pytest
import torch

from lip2speech_tpu.cli import find_max_duration as jfmd
from lip2speech_tpu.core.config import preset as jpreset
from lip2speech_tpu.pipeline.synthesise import Lip2SpeechPipeline as JaxPipeline
from lip2speech_tpu_torch.cli import find_max_duration as tfmd
from lip2speech_tpu_torch.core.config import preset as tpreset
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline

from test_torch_modules import _np_tree

WAV_TOL = 1e-4          # of max |ref|


@pytest.fixture(scope="module")
def pipes():
    """The JAX tiny pipeline's random weights, and the port's pipeline with
    them, on the CPU."""
    jpipe = JaxPipeline.initialize_random(jpreset("tiny"), frames=8)
    tpipe = Lip2SpeechPipeline.from_jax_variables(
        tpreset("tiny"), _np_tree(jpipe.stage1_variables), _np_tree(jpipe.vocoder_params),
        device="cpu")
    return jpipe, tpipe


def test_probe_list_matches_jax(monkeypatch, capsys):
    """Both CLIs at --preset tiny, 1 s steps to 2 s: the same probes."""
    monkeypatch.setattr(sys, "argv", ["probe", "--preset", "tiny", "--max-seconds", "2",
                                      "--step-seconds", "1"])
    jfmd.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tfmd.main(["--preset", "tiny", "--max-seconds", "2", "--step-seconds", "1",
                     "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got["max_ok_seconds"] == ref["max_ok_seconds"] == 2
    keys = ("seconds", "frames", "ok")
    assert [{k: p[k] for k in keys} for p in got["probes"]] == [
        {k: p[k] for k in keys} for p in ref["probes"]] == [
        {"seconds": 1.0, "frames": 25, "ok": True}, {"seconds": 2.0, "frames": 50, "ok": True}]
    assert all(p["latency_ms"] > 0 and p["rtf"] > 0 for p in got["probes"])


def test_probe_waveform_matches_jax(pipes):
    """The 2 s probe (50 zero frames, a zero speaker) through the port's
    pipeline from the JAX weights, against the JAX tool's jitted call."""
    jpipe, tpipe = pipes
    result, wav = tfmd.probe(tpipe, 2.0)
    assert result["frames"] == 50 and wav.shape == (50 * 640,)
    fn = jpipe._jitted(None)
    ref = np.asarray(fn(jpipe.stage1_variables, jpipe.vocoder_params,
                        np.zeros((1, 50, 88, 88, 1), np.float32), np.ones((1, 50), bool),
                        np.zeros((1, 256), np.float32))[0])[0]
    assert np.abs(wav - ref).max() <= WAV_TOL * np.abs(ref).max()


def _failing_forward(pipe, exc, frames_ok: int):
    real = pipe.forward

    def forward(video, mask, spk):
        if video.shape[1] > frames_ok:
            raise exc
        return real(video, mask, spk)

    return forward


def test_out_of_memory_ends_the_probe_list(pipes, monkeypatch):
    """A probe that runs out of device memory is the last, marked not ok; the
    largest ok probe is the answer."""
    _, tpipe = pipes
    monkeypatch.setattr(tpipe, "forward", _failing_forward(
        tpipe, torch.cuda.OutOfMemoryError("CUDA out of memory"), 50))
    out = tfmd.probe_durations(tpipe, max_seconds=8, step_seconds=1)
    assert out["max_ok_seconds"] == 2
    assert [p["ok"] for p in out["probes"]] == [True, True, False]
    assert out["probes"][-1]["seconds"] == 3 and "out of memory" in out["probes"][-1]["error"]


def test_any_other_error_raises(pipes, monkeypatch):
    """A failing forward that is not out of memory (a kernel fault, a bad
    shape) fails the tool: the JAX tool would record it as the capacity
    limit (ROADMAP §3)."""
    _, tpipe = pipes
    monkeypatch.setattr(tpipe, "forward", _failing_forward(
        tpipe, RuntimeError("CUDA error: an illegal memory access"), 50))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tfmd.probe_durations(tpipe, max_seconds=8, step_seconds=1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only refusal")
def test_the_probe_runs_on_the_card_unless_told():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfmd.main(["--preset", "tiny", "--max-seconds", "1", "--step-seconds", "1"])
