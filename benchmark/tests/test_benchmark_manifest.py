"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds its
files by name."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import tiny

ROOT = harness.ROOT
M = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(M["workloads"]) <= 24


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16 and len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
    for word in M["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])


def test_names_units_and_entry_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert all(NAME.match(n) for n in names)
    assert len({w["name"] for w in M["workloads"]}) == len(M["workloads"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_resolves_its_files(name):
    cell = harness.load_cell(name)
    assert (harness.HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r.read) for r in cell.readers.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    moved = {m["moves"] for m in cell.per_layer}
    assert moved <= e2e
    assert cell.limits["limits"]


def test_per_layer_cells_report_what_they_move():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        for w in m.get("workloads", cells):
            assert w in cells
            e2e = [e for e in M["end_to_end"] if e["name"] == m["moves"]][0]
            assert w in e2e.get("workloads", cells)


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_configuration_matches_the_port(config):
    """The reference's sizes ("arch") are the port's preset's; the source's
    optimiser is the port's."""
    conf = harness.load_json(ROOT / config["file"])
    cfg = harness.port_config(conf)
    a, c = conf["arch"], cfg.model.conformer
    assert (a["conformer"]["dim"], a["conformer"]["ffn_dim"], a["conformer"]["heads"],
            a["conformer"]["layers"], a["conformer"]["conv_kernel"], a["conformer"]["input_dim"]) == (
        c.dim, c.ffn_dim, c.heads, c.layers, c.conv_kernel, c.input_dim)
    assert a["conformer"]["dropout"] == c.dropout and a["final_dropout"] == cfg.model.final_dropout
    assert a["vocab"] == cfg.model.units.vocab_size and a["num_special"] == cfg.model.units.num_special
    v = cfg.vocoder
    for k, val in a["vocoder"].items():
        got = getattr(v, k)
        assert json.loads(json.dumps(got)) == val, k
    if a["frontend"] == "avhubert":
        fe = cfg.model.frontend
        assert (fe.kind, fe.encoder_dim, fe.encoder_heads, fe.encoder_ffn_dim, fe.encoder_layers) == (
            "avhubert", a["avhubert"]["dim"], a["avhubert"]["heads"], a["avhubert"]["ffn_dim"],
            a["avhubert"]["layers"])
    s1 = cfg.stage1
    for k, val in conf["optimizer"].items():
        assert getattr(s1, k) == val, k
    assert conf["reduced"] == config["reduced"]
    for k in conf["reduced"]:
        assert conf.get("published", {}).get(k) not in (None, conf[k])
