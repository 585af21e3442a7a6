"""Maintenance on the presets and layouts ``test_torch_maintenance.py``
leaves out, against the reference on the conftest index: one pass each on
``odinann_cache`` (packed pages under the NAVIS cache), ``layout_only``
and ``sel_vec`` (decoupled with a static top-up) and navis with bitmap
visited sets (refine's traversal); then inserts into the reclaimed slots
under the packed layout (odinann, after the defrag) and FreshDiskANN's
merge into freed slots.  Every ``EngineState`` field and the OpStats
exact; victims spare vertex 0's out-neighbors (the vertex-0 page is the
one known difference, ROADMAP queue 3, shown in
``test_torch_maintenance.py``)."""
import jax.numpy as jnp
import pytest

from repro_torch.core import check_invariants
from test_torch_engine import _same_tree
from test_torch_insert import _t, _wave
from test_torch_maintenance import _consolidate_both, _delete, _pair
from test_torch_presets import adopt, spec_of
from _torch_threads import one_torch_thread  # noqa: F401


def _insert_both(pair, wave, batch=False):
    """One insert wave (``insert_batch`` if ``batch``) in both packages:
    the OpStats and the state equal.  Returns the new pair."""
    eng, state, teng, tstate = pair
    name = "insert_batch" if batch else "insert_many"
    stats, state = getattr(eng, name)(state, jnp.asarray(wave))
    tstats, tstate = getattr(teng, name)(tstate, _t(wave))
    _same_tree(tstats, stats, f"{name} OpStats")
    _same_tree(tstate, state, f"after {name}")
    return eng, state, teng, tstate


@pytest.mark.parametrize("name,overrides", [
    ("odinann_cache", {}), ("layout_only", {}), ("sel_vec", {}),
    ("navis", {"visited_impl": "bitmap"})],
    ids=["odinann_cache", "layout_only", "sel_vec", "navis_bitmap"])
def test_consolidate_matches_reference(name, overrides, dataset,
                                       shared_bundle):
    """An insert wave of 20 (young vertices for refine), 40 deletes, one
    pass: every field equal, the victims in the free list, every
    invariant."""
    pair = adopt(spec_of(name, **overrides), dataset, shared_bundle)
    pair = _insert_both(pair, _wave(dataset, 20, seed=31))
    assert int(pair[3].young_mask.sum()) == 20
    eng, state, teng, tstate, victims = _delete(pair, 40, 7)
    _, tst = _consolidate_both(eng, state, teng, tstate, name)
    assert sorted(tst.free_list[:tst.free_count].tolist()) == \
        sorted(victims.tolist())
    assert int(tst.young_mask.sum()) == 0
    inv = check_invariants(tst.store, tst.tombstone)
    assert all(inv.values()), inv


def test_packed_inserts_into_reclaimed_slots_match_reference(odinann,
                                                             dataset):
    """odinann after a pass over 40 deletes: a wave of 30 and then 16
    sequential inserts take the reclaimed slots (last reclaimed first),
    then fresh ones; the packed commit writes into the defragged pages.
    Every field and OpStat equal."""
    eng, state, teng, tstate, victims = _delete(_pair(odinann), 40, 7)
    st, tst = _consolidate_both(eng, state, teng, tstate, "odinann")
    pair = _insert_both((eng, st, teng, tst), _wave(dataset, 30, seed=41))
    assert pair[3].free_count == 10 and pair[3].store.count == 1200
    pair = _insert_both(pair, _wave(dataset, 16, seed=42), batch=True)
    tst = pair[3]
    assert tst.free_count == 0 and tst.store.count == 1206
    assert not tst.tombstone[_t(victims).long()].any()
    inv = check_invariants(tst.store, tst.tombstone)
    assert all(inv.values()), inv


def test_buffered_merge_into_freed_slots_matches_reference(freshdiskann,
                                                           dataset):
    """FreshDiskANN after a pass over 40 deletes: 30 buffered inserts, then
    the merge inserts them into the reclaimed slots.  Every field and the
    merge's OpStats equal."""
    eng, state, teng, tstate, _ = _delete(_pair(freshdiskann), 40, 7)
    st, tst = _consolidate_both(eng, state, teng, tstate, "freshdiskann")
    eng, st, teng, tst = _insert_both((eng, st, teng, tst),
                                      _wave(dataset, 30, seed=43))
    assert tst.buf_count == 30
    stats, st = eng.merge(st)
    tstats, tst = teng.merge(tst)
    _same_tree(tstats, stats, "merge OpStats")
    _same_tree(tst, st, "after the merge")
    assert tst.buf_count == 0 and tst.free_count == 10
    assert tst.store.count == 1200
    inv = check_invariants(tst.store, tst.tombstone)
    assert all(inv.values()), inv
