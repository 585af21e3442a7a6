"""The harness finds every configuration, mix, loop, limit and metric by
name, and ``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

from navisbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "navisbench/run.py"]
    assert BENCH["paths"] == ["navisbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    assert len(set(names)) == len(names)


def test_entries_have_only_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e["name"]


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    entry = harness.workload(BENCH, cell)
    assert entry["chips"] == 1
    cfg = harness.load_config(REPO, BENCH, entry["config"])
    mix = harness.load_traffic(REPO, entry["traffic"])
    limits = harness.load_limits(REPO, cell)
    loop = harness.load_loop(REPO, mix["loop"])
    assert callable(loop.setup) and callable(loop.window)
    assert {"bad_answers", "dist_err"} <= set(limits)
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf["file"].startswith("navisbench/")
    for key in conf["reduced"]:
        assert key in cfg and key in cfg["assumed"]
    # every cell: set-up, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")]
    per = harness.metrics_of(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", [m["name"] for g in ("end_to_end",
                                                       "per_layer")
                                  for m in BENCH[g]])
def test_every_metric_has_a_reader(name):
    assert callable(harness.load_metric(REPO, name).read)


def test_each_config_is_used_and_its_own_file():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_unknown_names_are_refused():
    with pytest.raises(harness.BenchmarkError):
        harness.workload(BENCH, "no.such.cell")
    with pytest.raises(harness.BenchmarkError):
        harness.load_metric(REPO, "no_such_metric")
    with pytest.raises(harness.BenchmarkError):
        harness.load_traffic(REPO, "no_such_mix")


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxish", types.ModuleType("jaxish"))
    found = harness.forbidden_modules()
    assert "repro_torch_like" not in found and "jaxish" not in found
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("x"))
    assert "flax.core" in harness.forbidden_modules()
