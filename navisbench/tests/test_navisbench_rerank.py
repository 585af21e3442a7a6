"""The readers of CASR's rows (``rerank_rows_per_query``) and of
``casr_rerank``'s roofline: the bytes a launch must move, by hand on a
small shape; the traced waves they are read over; values from a known
record; and nothing, raising nothing, on a record without the engine's
rerank counts (the engine before they existed)."""
import pytest

import _navisbench_tiny as tiny
from navisbench import harness, rerank_bytes
from navisbench.tracing import PEAK_BYTES_S

NEW = ["rerank_rows_per_query", "casr_rerank_roofline"]


def test_casr_bytes_by_hand():
    # 3 lanes, pools of 5, D 4, k 2, 7 distinct rows loaded
    rows = 7 * 4 * 4            # the loaded rows, f32
    reads = 3 * 4 * 4 + 3 * 5 * 4          # queries f32, pool ids i32
    writes = 3 * 5 * (4 + 1) + 3 * 2 * (4 + 4) + 3 * (8 + 4)
    assert rerank_bytes.casr_bytes(7, 3, 5, 4, 2) == rows + reads + writes
    assert rerank_bytes.casr_bytes(0, 0, 40, 768, 10) == 0


def test_cell_shape_is_the_configurations():
    assert rerank_bytes.cell_shape(tiny.REPO, "deep96.query") == \
        (96, 40, 10)
    assert rerank_bytes.cell_shape(tiny.REPO, "fineweb768.query") == \
        (768, 40, 10)


def _record(counts: dict | None, trace: dict | None = None,
            trace_t0=None) -> harness.Record:
    rec = harness.Record(cell="deep96.query", trace=trace, trace_t0=trace_t0)
    timing = {"wave_s": 0.5, "rerank_s": 0.1, "replay_s": 0.2}
    for i, n in enumerate((4, 6, 8)):
        tm = dict(timing)
        if counts is not None:
            tm["counts"] = {k: v * (i + 1) for k, v in counts.items()}
        rec.ops.append({"kind": "search", "n": n, "t0": float(i),
                        "t1": i + 0.9, "timing": tm})
    return rec


def _trace(dev_s: float, launches: int) -> dict:
    return {"busy_s": 1.0, "window_s": 2.0, "adc_bytes": 0,
            "kernels": {"casr_rerank_kernel": [dev_s, launches]}}


@pytest.mark.parametrize("name", NEW)
def test_reads_nothing_without_the_count(name):
    reader = harness.load_metric(tiny.REPO, name)
    old = {"entry_iters": 2, "traverse_iters": 5, "traverse_lanes": 20,
           "visited_redo": 0}
    for rec in (_record(old, _trace(1e-3, 2), 0.5), _record(None),
                harness.Record(cell="deep96.query")):
        assert reader.read(rec) is None


def test_rows_a_query_from_a_known_record():
    reader = harness.load_metric(tiny.REPO, "rerank_rows_per_query")
    rec = _record({"rerank_rows": 50, "rerank_groups": 9})
    # 50 + 100 + 150 rows over 4 + 6 + 8 queries
    assert reader.read(rec) == pytest.approx(300 / 18)


def test_roofline_from_a_known_record():
    reader = harness.load_metric(tiny.REPO, "casr_rerank_roofline")
    rec = _record({"rerank_rows": 50, "rerank_groups": 9,
                   "rerank_rows_distinct": 20}, _trace(2e-6, 2),
                  trace_t0=0.5)
    # the traced waves: the two that began after 0.5 s
    assert [op["n"] for op in rerank_bytes.traced_waves(rec, 2)] == [6, 8]
    moved = (rerank_bytes.casr_bytes(40, 6, 40, 96, 10) +
             rerank_bytes.casr_bytes(60, 8, 40, 96, 10))
    assert reader.read(rec) == pytest.approx(
        100 * moved / PEAK_BYTES_S / 2e-6)


def test_roofline_reads_nothing_without_a_launch_or_enough_waves():
    reader = harness.load_metric(tiny.REPO, "casr_rerank_roofline")
    counts = {"rerank_rows": 50, "rerank_groups": 9,
              "rerank_rows_distinct": 20}
    assert reader.read(_record(counts, _trace(0.0, 0), 0.5)) is None
    assert reader.read(_record(counts, _trace(1e-3, 3), 0.5)) is None
    assert reader.read(_record(counts, {"kernels": {}}, 0.5)) is None
