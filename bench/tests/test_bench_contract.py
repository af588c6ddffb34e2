"""BENCHMARK.json, the cell, configuration, traffic and metric files: the
names, units and keys the contract allows, and that each piece is found
by its name."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contracts_keys_and_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - KEYS[section] - {"workloads"}
        assert KEYS[section] <= set(e) and not extra, (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert line(e[key]), (e["name"], key)


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(line(w) for w in BENCH["command"])
    assert BENCH["command"][1] == "bench/run.py"


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_match(cell):
    from bench import harness

    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = harness.cell(cell)
    assert entry["chips"] in (1, 4) and c["chips"] == entry["chips"]
    assert c["config"] == entry["config"] and c["traffic"] == entry["traffic"]
    assert c["why"] == entry["why"] and line(c["why"])
    assert (ROOT / "bench" / "drivers" / f"{c['driver']}.py").exists()
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert harness.config(c["config"])["source"] == conf["source"]
    assert set(c["limits"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert harness.traffic(c["traffic"])["kind"] == "lm_corpus"
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_config_files(conf):
    from bench import harness

    entry = next(c for c in BENCH["configs"] if c["name"] == conf)
    assert entry["file"] == f"bench/configs/{conf}.json"
    c = harness.config(conf)
    assert c["name"] == conf and c["reduced"] == entry["reduced"]
    from bench.drivers import shared

    shared.program_config(c)  # what differs from the registry is listed
    assert any(w["config"] == conf for w in BENCH["workloads"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files_declare_their_entry(name):
    from bench import harness

    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = harness.metric(name)
    assert (mod.NAME, mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["better"], entry["layer"],
        entry["moves"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert entry["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    assert entry["workloads"] and set(entry["workloads"]) <= cells


def test_every_file_under_paths_is_named_from_allowed_characters():
    for p in (ROOT / "bench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert FILE.match(rel) and len(rel) <= 200, rel
