"""Each cell, cut to a tiny size, runs end to end on the CPU through the
kernels' plain versions (``run.main``'s test route, in a fresh process)
and prints one result line; a dummy metric and a dummy cell added as
files and entries are picked up with no other edit."""
import json
import shutil

import pytest

import _navisbench_tiny as tiny

CELLS = [w["name"] for w in json.loads(
    (tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]
SCENARIOS = [f"{c}:{t}" for c in CELLS for t in (0, 1)] + ["dummy.query:1"]


def _add_dummy(root):
    """A per-layer metric and a cell over an existing mix, as files and
    entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy.query", "config": "deep96",
                               "traffic": "dummy", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_waves", "unit": "waves",
                               "better": "lower", "source": "program_span",
                               "layer": "search fan-out",
                               "moves": "search_qps",
                               "workloads": ["dummy.query"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("search_qps", "recall_at_10"):
            m["workloads"].append("dummy.query")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pkg = root / "navisbench"
    shutil.copy(pkg / "traffic" / "query.json", pkg / "traffic" / "dummy.json")
    shutil.copy(pkg / "checks" / "deep96.query.json",
                pkg / "checks" / "dummy.query.json")
    (pkg / "metrics" / "dummy_waves.py").write_text(
        "def read(rec):\n    return len(rec.ops_of('search'))\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("tiny"))
    _add_dummy(root)
    return root


@pytest.fixture(scope="module")
def results(root):
    return tiny.drive(root, SCENARIOS)


def _expected(root, cell: str, kind: str) -> set:
    from navisbench import harness
    bench = harness.load_benchmark(root)
    return {m["name"] for m in harness.metrics_of(bench, cell, kind)
            if m["source"] != "device_trace"}


@pytest.mark.parametrize("scenario", SCENARIOS[:-1])
def test_cell_runs_and_prints_one_line(root, results, scenario):
    r = results[scenario]
    assert r["rc"] == 0, r["stderr"]
    res = r["result"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    cell, trace = scenario.split(":")
    kind = "per_layer" if trace == "1" else "end_to_end"
    # device-trace metrics read nothing on the CPU, and are left out
    assert set(res["metrics"]) == _expected(root, cell, kind)
    for m in res["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    assert res["device"]["platform"] == "cpu"
    for name, v in res["checks"].items():
        assert f"navisbench check {name}: " in r["stderr"]
        assert v["value"] <= v["limit"]


def test_dummy_cell_and_metric_are_picked_up(results):
    r = results["dummy.query:1"]
    assert r["rc"] == 0, r["stderr"]
    metrics = r["result"]["metrics"]
    assert metrics["dummy_waves"]["value"] >= 1
    assert metrics["dummy_waves"]["unit"] == "waves"
