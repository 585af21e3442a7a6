"""The readers of the search wave's stage spans and host reads: a tiny CPU
run at ``--trace 1`` reads each of them, one at ``--trace 0`` none; on
waves whose timing lacks the engine's spans, reads and counts, each
reads nothing and raises nothing."""
import pytest

import _navisbench_tiny as tiny
from navisbench import harness

NEW = ["entry_ms_per_wave.query", "disk_ms_per_wave.query",
       "host_reads_per_wave.query", "read_wait_ms_per_wave.query",
       "active_lane_share.query"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("tiny"))
    return tiny.drive(root, ["deep96.query:1", "deep96.query:0"])


def test_trace_1_reads_every_new_metric(results):
    r = results["deep96.query:1"]
    assert r["rc"] == 0, r["stderr"]
    m = r["result"]["metrics"]
    assert set(NEW) <= set(m)
    assert m["entry_ms_per_wave.query"]["value"] > 0
    assert m["disk_ms_per_wave.query"]["value"] > 0
    assert m["host_reads_per_wave.query"]["value"] >= 4
    assert m["read_wait_ms_per_wave.query"]["value"] >= 0
    assert 0 < m["active_lane_share.query"]["value"] <= 100
    assert m["active_lane_share.query"]["unit"] == "%"


def test_trace_0_reads_none_of_them(results):
    r = results["deep96.query:0"]
    assert r["rc"] == 0, r["stderr"]
    assert not set(NEW) & set(r["result"]["metrics"])


def _record(timing: dict) -> harness.Record:
    rec = harness.Record(cell="deep96.query")
    rec.ops = [{"kind": "search", "n": 4, "t0": 0.0, "t1": 1.0,
                "timing": dict(timing)} for _ in range(2)]
    rec.counters = {"search": {"hops": 20}, "insert": {"hops": 0}}
    return rec


@pytest.mark.parametrize("name", NEW)
def test_reads_nothing_without_the_engines_record(name):
    reader = harness.load_metric(tiny.REPO, name)
    rec = _record({"wave_s": 0.5, "rerank_s": 0.1, "replay_s": 0.2})
    assert reader.read(rec) is None
    assert reader.read(harness.Record(cell="deep96.query")) is None


class _Span:
    def __init__(self, name, t0, t1):
        self.name, self.t0, self.t1 = name, t0, t1


def test_values_from_a_known_record():
    rec = _record({
        "wave_s": 0.5, "rerank_s": 0.1, "replay_s": 0.2,
        "spans": [_Span("entry", 1.0, 1.002), _Span("traverse", 1.002,
                                                    1.010)],
        "reads": {"entry/loop": [3, 0.001], "traverse/loop": [6, 0.0005],
                  "mask/timing": [1, 0.002]},
        "counts": {"entry_iters": 2, "traverse_iters": 5,
                   "traverse_lanes": 20, "visited_redo": 0}})
    got = {n: harness.load_metric(tiny.REPO, n).read(rec) for n in NEW}
    assert got["entry_ms_per_wave.query"] == pytest.approx(2.0)
    assert got["disk_ms_per_wave.query"] == pytest.approx(8.0)
    assert got["host_reads_per_wave.query"] == 10
    # the entrance's and the traversal's reads only, not the timing sync
    assert got["read_wait_ms_per_wave.query"] == pytest.approx(1.5)
    # 20 hops over 2 waves of 20 lane steps each
    assert got["active_lane_share.query"] == pytest.approx(50.0)


def test_lane_share_reads_nothing_without_the_lane_count():
    rec = _record({"wave_s": 0.5, "rerank_s": 0.1, "replay_s": 0.2,
                   "counts": {"entry_iters": 2, "traverse_iters": 5,
                              "visited_redo": 0}})
    reader = harness.load_metric(tiny.REPO, "active_lane_share.query")
    assert reader.read(rec) is None
