"""The port's AVSpeech planner (lip2speech_tpu_torch/cli/avspeech.py)
against the JAX package's: the parsed segments and the planned commands
equal, and the written script equal byte for byte, with every socket made
to raise (the planner reaches no network)."""

import socket
import sys

import pytest

from lip2speech_tpu.cli import avspeech as javs
from lip2speech_tpu_torch.cli import avspeech as tavs

ROWS = ["abc123XYZ_-,10.5,14.25,0.5,0.4", "short,3.0,3.5,0.1,0.2",
        "long1,0.0,30.0,0.3,0.3", "bad,1.0", "it's;rm -rf,100.0,101.75,0.9,0.8",
        "edge,2.0,26.0,0.5,0.5"]


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise OSError("the planner must not open a socket")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket, "getaddrinfo", refuse)


def test_parse_and_plan_match_jax(no_network, tmp_path):
    path = tmp_path / "avspeech.csv"
    path.write_text("\n".join(ROWS) + "\n")
    got, ref = tavs.parse_csv(path), javs.parse_csv(path)
    assert [vars(s) for s in got] == [vars(s) for s in ref] and len(got) == 5
    assert [s.clip_id for s in got] == [s.clip_id for s in ref]
    for kwargs in ({}, {"min_duration": 0.25, "max_duration": 40.0}):
        cmds = tavs.plan_download(got, tmp_path / "out", **kwargs)
        assert cmds == javs.plan_download(ref, tmp_path / "out", **kwargs)
    assert len(tavs.plan_download(got, tmp_path / "out")) == 3


def test_main_writes_the_same_script(no_network, tmp_path, monkeypatch, capsys):
    path = tmp_path / "avspeech.csv"
    path.write_text("\n".join(ROWS) + "\n")
    argv = ["--csv", str(path), "--out-dir", str(tmp_path / "out")]
    monkeypatch.setattr(sys, "argv", ["avspeech", *argv, "--script-path", str(tmp_path / "j.sh")])
    javs.main()
    got = tavs.main([*argv, "--script-path", str(tmp_path / "p.sh")])
    assert got == {"segments": 5, "planned": 3, "script": str(tmp_path / "p.sh")}
    assert (tmp_path / "p.sh").read_bytes() == (tmp_path / "j.sh").read_bytes()
    assert capsys.readouterr().out.count('"planned": 3') == 2
