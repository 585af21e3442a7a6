"""The port's recorder (``repro_torch.spans``) in the engine's calls, on the
CPU: a ``search_many`` wave's spans, host reads and loop counts, the
timing keys computed from them, and the reads it misses (none: every
conversion of a device value to a host number on the wave's path in
``core/search.py``, ``core/visited.py`` and ``core/engine.py`` goes
through ``spans.read``)."""
import os
import sys
import threading

import pytest
import torch

from repro_torch import random as jr
from repro_torch import spans
from repro_torch.core import Engine, preset
from repro_torch.core import casr as casr_mod
from repro_torch.core import search as search_mod
from repro_torch.data.pipeline import insert_stream, make_clustered, \
    query_stream
from _torch_threads import one_torch_thread  # noqa: F401

STAGES = ["lut", "entry", "traverse", "mask", "rerank", "replay"]
ROUTED = {os.path.join("core", f) for f in ("search.py", "visited.py",
                                            "engine.py")}


def _spec(**kw):
    return preset("navis", dim=32, r=12, pq_m=8, e_search=16, e_pos=24,
                  max_hops=48, cache_capacity_pages=64, n_max=1200, **kw)


@pytest.fixture(scope="module")
def built():
    gen = torch.Generator().manual_seed(5)
    vecs, _, cents = make_clustered(gen, 800, 32, n_clusters=8)
    eng = Engine(_spec(), device="cpu")
    state = eng.build(jr.PRNGKey(3), vecs, build_block=64, build_e_pos=24)
    return eng, state, cents


@pytest.fixture(scope="module")
def queries(built):
    return query_stream(torch.Generator().manual_seed(7), built[2], 200)


@pytest.fixture
def wave(built, queries, monkeypatch):
    """One wave, with the disk traversal's result kept."""
    eng, state, _ = built
    kept = []
    inner = search_mod.disk_traverse

    def traverse(*a, **kw):
        kept.append(inner(*a, **kw))
        return kept[-1]

    monkeypatch.setattr(search_mod, "disk_traverse", traverse)
    eng.search_many(state, queries)
    return eng.last_wave_timing, kept[0]


def test_spans_nest_under_search_many(wave):
    tm, _ = wave
    sp = tm["spans"]
    assert [s.name for s in sp] == STAGES + ["search_many"]
    assert len({s.wave for s in sp}) == 1
    root = sp[-1]
    assert root.parent is None
    for a, b in zip(sp[:len(STAGES)], sp[1:len(STAGES)]):
        assert a.parent == "search_many" and a.t1 <= b.t0
    for s in sp[:-1]:
        assert root.t0 <= s.t0 <= s.t1 <= root.t1


def test_timing_keys_are_span_durations(wave):
    tm, _ = wave
    at = {s.name: s for s in tm["spans"]}
    assert tm["rerank_s"] == at["rerank"].t1 - at["rerank"].t0
    assert tm["replay_s"] == at["replay"].t1 - at["replay"].t0
    assert tm["wave_s"] == at["replay"].t0 - at["search_many"].t0
    assert tm["wave_s"] > 0 and tm["rerank_s"] > 0 and tm["replay_s"] > 0


def test_loop_reads_are_iterations_plus_one(wave):
    tm, res = wave
    reads, counts = tm["reads"], tm["counts"]
    assert set(counts) == {"entry_iters", "entry_lane_steps",
                           "traverse_iters", "traverse_lanes",
                           "visited_redo", "rerank_rows", "rerank_groups",
                           "rerank_rows_distinct"}
    assert counts["entry_iters"] > 0
    assert reads["entry/loop"][0] == counts["entry_iters"] + 1
    assert reads["traverse/loop"][0] == counts["traverse_iters"] + 1
    assert counts["traverse_iters"] == int(res.hops.max())
    assert counts["traverse_lanes"] == \
        counts["traverse_iters"] * res.hops.shape[0]
    assert reads["entry/seed"][0] == 2


def test_timing_syncs_sit_in_their_stages(wave):
    reads = wave[0]["reads"]
    for stage in ("mask", "rerank", "search_many", "replay"):
        assert reads[f"{stage}/timing"][0] == 1
    assert sum(n for k, (n, _) in reads.items()
               if k.endswith("/timing")) == 4
    for n, s in reads.values():
        assert n > 0 and s >= 0


def test_rerank_counts_are_casr_sums(built, queries, monkeypatch):
    """A wave's ``rerank_rows`` and ``rerank_groups`` are the sums of
    ``n_loaded`` and ``n_groups`` of a direct ``casr_rerank`` call on the
    wave's pools, and ``rerank_rows_distinct`` the distinct ids it loaded,
    read once at the rerank's sync: no sync of their own."""
    eng, state, _ = built
    seen = []
    inner = casr_mod.casr_rerank

    def rerank(*a, **kw):
        seen.append((a, kw))
        return inner(*a, **kw)

    monkeypatch.setattr(casr_mod, "casr_rerank", rerank)
    eng.search_many(state, queries)
    tm = eng.last_wave_timing
    (a, kw), = seen
    direct = inner(*a, **kw)
    assert tm["counts"]["rerank_rows"] == int(direct.n_loaded.sum()) > 0
    assert tm["counts"]["rerank_groups"] == int(direct.n_groups.sum()) > 0
    distinct = direct.ids[direct.loaded].unique().numel()
    assert tm["counts"]["rerank_rows_distinct"] == distinct
    assert 0 < distinct < tm["counts"]["rerank_rows"]
    assert tm["reads"]["rerank/counts"][0] == 1
    assert {k for k in tm["reads"] if k.endswith("/timing")} == {
        f"{s}/timing" for s in ("mask", "rerank", "search_many", "replay")}


def test_sequential_search_counts_no_rerank_rows(built, queries):
    """Only a wave records the rerank's counts: a search threaded through
    the cache (``search_batch``) adds none and reads none at its rerank."""
    eng, state, _ = built
    spans.take()
    eng.search_batch(state, queries[:2])
    rec = spans.take()
    assert not {"rerank_rows", "rerank_groups",
                "rerank_rows_distinct"} & set(rec["counts"])
    assert "rerank/counts" not in rec["reads"]
    assert "rerank/timing" in rec["reads"]


def test_redo_count_matches_its_reads(wave):
    """Every redo of ``visited.add`` is one ``True`` of its read; each
    redo probes key by key, which reads at least once per key with
    ``ok`` set unless the first chunk settles it."""
    tm, _ = wave
    redo = tm["counts"]["visited_redo"]
    add = sum(n for k, (n, _) in tm["reads"].items()
              if k.endswith("/visited.add"))
    assert 0 <= redo <= add
    key_reads = sum(n for k, (n, _) in tm["reads"].items()
                    if k.endswith("/visited.add_key"))
    assert (redo == 0) == (key_reads == 0)


def test_record_does_not_grow_across_waves(built, queries):
    eng, state, _ = built
    sizes, waves = [], []
    for _ in range(3):
        _, _, _, state = eng.search_many(state, queries)
        tm = eng.last_wave_timing
        sizes.append((len(tm["spans"]), len(tm["reads"])))
        waves.append(tm["spans"][0].wave)
    assert len(set(sizes)) == 1 and sizes[0][0] == len(STAGES) + 1
    assert waves[0] < waves[1] < waves[2]
    left = spans.take()
    assert left["spans"] == [] and left["reads"] == {} and \
        left["counts"] == {}


def test_every_host_read_of_the_wave_is_routed(built, queries,
                                               monkeypatch):
    """Conversions of tensors to host values during one wave, attributed
    to the first caller outside the recorder: those made from the search
    path's three files equal the recorder's reads less its ``timing``
    syncs (which convert nothing)."""
    eng, state, _ = built
    calls = {}
    busy = [False]
    here = os.path.abspath(spans.__file__)

    def wrap(orig):
        def conv(self, *a):
            if not busy[0]:
                f = sys._getframe(1)
                while os.path.abspath(f.f_code.co_filename) == here:
                    f = f.f_back
                name = f.f_code.co_filename
                calls[name] = calls.get(name, 0) + 1
            busy[0] = True
            try:
                return orig(self, *a)
            finally:
                busy[0] = False
        return conv

    for attr in ("__bool__", "__int__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, attr,
                            wrap(getattr(torch.Tensor, attr)))
    eng.search_many(state, queries)
    monkeypatch.undo()
    reads = eng.last_wave_timing["reads"]
    routed = sum(n for k, (n, _) in reads.items()
                 if not k.endswith("/timing"))
    from_path = sum(n for f, n in calls.items()
                    if any(f.endswith(r) for r in ROUTED))
    assert routed > 0
    assert from_path == routed, calls


def test_read_and_count_outside_a_span():
    spans.take()
    assert spans.read(torch.tensor(True), "probe") is True
    assert spans.read(torch.tensor(7), "probe") == 7
    spans.count("c", 3)
    spans.sync(torch.zeros(1))
    rec = spans.take()
    assert rec["reads"]["/probe"][0] == 2 and rec["reads"]["/timing"][0] == 1
    assert rec["counts"] == {"c": 3} and rec["spans"] == []


def test_a_root_span_starts_a_new_record():
    with spans.span("a") as a:
        spans.count("n")
        with spans.span("b") as b:
            spans.read(torch.tensor(1), "x")
    first = spans.take()["wave"]
    assert a.parent is None and b.parent == "a"
    assert a.t0 <= b.t0 <= b.t1 <= a.t1 and a.seconds >= b.seconds >= 0
    with spans.span("a"):
        spans.count("n")
    with spans.span("c"):
        pass
    rec = spans.take()
    assert rec["wave"] > first
    assert [s.name for s in rec["spans"]] == ["c"] and rec["counts"] == {}


def test_an_exception_closes_its_spans():
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError
    with spans.span("next"):
        pass
    rec = spans.take()
    assert [(s.name, s.parent) for s in rec["spans"]] == [("next", None)]


def test_each_thread_keeps_its_own_record():
    seen = {}

    def other():
        with spans.span("other"):
            spans.count("x")
        seen.update(spans.take())

    with spans.span("mine"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    rec = spans.take()
    assert [s.name for s in rec["spans"]] == ["mine"]
    assert rec["counts"] == {} and seen["counts"] == {"x": 1}
    assert [s.name for s in seen["spans"]] == ["other"]
    assert seen["wave"] != rec["wave"]


def test_insert_many_timing_from_its_spans(built):
    eng, state, cents = built
    vs = insert_stream(torch.Generator().manual_seed(9), cents, 16)
    with spans.span("caller"):
        eng.insert_many(state, vs)
    assert set(eng.last_wave_timing) == {"seek_s", "replay_s", "commit_s"}
    assert all(v >= 0 for v in eng.last_wave_timing.values())
    rec = spans.take()
    names = [(s.name, s.parent) for s in rec["spans"]]
    assert names == [("seek", "caller"), ("replay", "caller"),
                     ("commit", "caller"), ("caller", None)]
    at = {s.name: s for s in rec["spans"]}
    for k in ("seek", "replay", "commit"):
        assert abs(eng.last_wave_timing[f"{k}_s"] - at[k].seconds) < 1e-6
    assert rec["counts"]["traverse_iters"] > 0


def test_consolidate_timing_from_its_spans(built):
    eng, state, _ = built
    state = eng.delete_many(state, list(range(0, 200, 3)))
    with spans.span("caller"):
        eng.consolidate(state)
    assert set(eng.last_maint_timing) == {"refine_s", "refine_blocks",
                                          "reclaim_defrag_s", "refresh_s",
                                          "repair_s"}
    rec = spans.take()
    assert [(s.name, s.parent) for s in rec["spans"]] == [
        ("repair", "caller"), ("refine", "caller"),
        ("reclaim_defrag", "caller"), ("refresh", "caller"),
        ("caller", None)]
    at = {s.name: s for s in rec["spans"]}
    for k in ("repair", "refine", "reclaim_defrag", "refresh"):
        assert abs(eng.last_maint_timing[f"{k}_s"] - at[k].seconds) < 1e-6
