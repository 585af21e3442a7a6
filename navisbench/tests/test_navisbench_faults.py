"""The timed path broken underneath a run (the look for a card skipped):
``correct`` comes out false for each fault the query cell can have
(``navisbench/faults.py``): half a wave searched, an answer altered, the
lanes' candidates swapped before the rerank, the traversal cut to one
hop, the cache's replay skipped, and the state handed back unchanged.
No cell spans chips."""
import pytest

import _navisbench_tiny as tiny

FAULTS = [f"deep96.query:0:{name}" for name in (
    "half_searched", "answer_altered", "lanes_swapped", "one_hop",
    "replay_skipped", "state_unchanged")]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return tiny.drive(tiny.make_root(tmp_path_factory.mktemp("tiny")),
                      FAULTS)


@pytest.mark.parametrize("scenario", FAULTS)
def test_fault_is_not_correct(results, scenario):
    r = results[scenario]
    assert r["rc"] == 0, r["stderr"]
    res = r["result"]
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
