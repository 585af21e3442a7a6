"""The port's sequential paths and deletes against the reference on the
conftest ``navis`` index: ``search`` / ``search_batch`` and ``insert`` /
``insert_batch`` (each traversal threaded through the cache page by page),
``delete`` / ``delete_many``, the capacity guard, free-list reuse; and the
properties the port must hold on its own: a wave of one is the sequential
insert, no operation touches its input state, ``search_many`` answers as
``search_batch`` does, and the fan-out keeps the sequential path's
recall."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # offline container: seeded shim
    from _prop import given, settings, st

from repro.core import Engine as JEngine
from repro.core import preset as jpreset
from repro_torch import interop
from repro_torch.core import brute_force_topk, check_invariants, recall_at_k
from test_torch_engine import _ids_equal, _same, _same_dicts, _same_tree
from test_torch_insert import _t, _wave
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port(navis):
    eng, state = navis
    return (interop.engine_from(eng, device="cpu"),
            interop.engine_state_from(state, device="cpu"))


def _well_formed(state):
    inv = check_invariants(state.store)
    assert all(inv.values()), inv


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_insert_batch_matches_reference(navis, port, dataset):
    """Four sequential inserts (the first promotes an entrance member):
    the whole state, cache included, and the per-insert OpStats."""
    eng, state = navis
    teng, tstate = port
    vs = _wave(dataset, 4, seed=9)
    stats, st_j = eng.insert_batch(state, jnp.asarray(vs))
    tstats, st_t = teng.insert_batch(tstate, _t(vs))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t, st_j, "state")
    assert int(st_j.ent.count) > int(state.ent.count)


def test_insert_matches_reference_page_seen(navis, port, dataset):
    """One ``insert``: stats, state and the page set its traversal read."""
    eng, state = navis
    teng, tstate = port
    v = _wave(dataset, 1, seed=13)[0]
    stats, st_j, seen = eng.insert(state, jnp.asarray(v))
    tstats, st_t, tseen = teng.insert(tstate, _t(v))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t, st_j, "state")
    _same_tree(tseen, seen, "page_seen")


def test_search_batch_matches_reference(navis, port, dataset):
    """Eight sequential searches: ids and the threaded cache exact (the
    first searches' admissions change later searches' hits), distances to
    1e-4, OpStats and the search counters exact."""
    eng, state = navis
    teng, tstate = port
    qs = np.array(dataset["queries"][:8])
    ids, dists, stats, st_j = eng.search_batch(state, jnp.asarray(qs))
    tids, tdists, tstats, st_t = teng.search_batch(tstate, _t(qs))
    _ids_equal(tids.numpy(), ids, qs, np.asarray(state.store.vectors),
               "search_batch")
    np.testing.assert_allclose(tdists.numpy(), dists, rtol=0, atol=1e-4)
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t.cache, st_j.cache, "cache")
    _same_tree(st_t.ctr_search, st_j.ctr_search, "ctr_search")


def test_search_matches_reference(navis, port, dataset):
    eng, state = navis
    teng, tstate = port
    q = np.array(dataset["queries"][9])
    ids, dists, stats, st_j = eng.search(state, jnp.asarray(q))
    tids, tdists, tstats, st_t = teng.search(tstate, _t(q))
    _same(tids, ids, "ids")
    np.testing.assert_allclose(tdists.numpy(), dists, rtol=0, atol=1e-4)
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t.cache, st_j.cache, "cache")


@pytest.mark.parametrize("vids", [
    [17],                          # a plain vertex
    "member",                      # an entrance member: scrub its edges
    "member_twice",                # idempotent within one call
    [5, -1, 900, 5, -1],           # padding and a repeat
], ids=["plain", "member", "member_twice", "padded"])
def test_delete_many_matches_reference(navis, port, vids):
    """Tombstones, n_deleted and the entrance (ids, main_to_ent, every
    reciprocal edge to a dropped member's slot) equal the reference's;
    deleting the same ids again changes nothing."""
    eng, state = navis
    teng, tstate = port
    ids = np.asarray(state.ent.ids)
    edges = np.asarray(state.ent.edges)
    slot = next(s for s in range(1, len(ids))
                if ids[s] >= 0 and (edges == s).sum() > 0)
    if vids == "member":
        vids = [int(ids[slot])]
    elif vids == "member_twice":
        vids = [int(ids[slot]), 3, int(ids[slot])]
    want = eng.delete_many(state, jnp.asarray(vids, jnp.int32))
    got = teng.delete_many(tstate, vids)
    _same_tree(got, want, "state")
    again = teng.delete_many(got, vids)
    _same_tree(again, want, "state after a second delete")
    if len(vids) == 1:
        _same_tree(teng.delete(tstate, vids[0]), want, "delete")


@pytest.fixture(scope="module")
def tight(dataset):
    """The reference's tight engine (n_max = count + 4), ported."""
    n_base = 400
    eng = JEngine(jpreset("navis", dim=48, r=16, n_max=n_base + 4,
                          e_search=32, e_pos=40, pq_m=24, max_hops=48,
                          cache_capacity_pages=128, buffer_max=32))
    state = eng.build(jax.random.PRNGKey(3), dataset["vecs"][:n_base],
                      build_block=64, build_e_pos=32)
    return (eng, state, interop.engine_from(eng, device="cpu"),
            interop.engine_state_from(state, device="cpu"))


def test_capacity_guard_sequential_matches_reference(tight, dataset):
    """Past n_max a sequential insert is skipped before it takes a page:
    four accepted, three dropped, state and stats as the reference's."""
    eng, state, teng, tstate = tight
    vs = _wave(dataset, 7, seed=21)
    flags = []
    for i in range(7):
        stats, state, _ = eng.insert(state, jnp.asarray(vs[i]))
        tstats, tstate, _ = teng.insert(tstate, _t(vs[i]))
        _same_tree(tstats, stats, f"insert {i} OpStats")
        flags.append(bool(tstats.dropped))
    assert flags == [False] * 4 + [True] * 3
    _same_tree(tstate, state, "state")
    assert tstate.store.count == tstate.store.n_max
    _well_formed(tstate)


def test_capacity_guard_wave_matches_reference(tight, dataset):
    """A wave past capacity commits its head and drops its tail (the
    dropped lanes still paid their seek)."""
    eng, state, teng, tstate = tight
    vs = _wave(dataset, 7, seed=22)
    stats, st_j = eng.insert_many(state, jnp.asarray(vs))
    tstats, st_t = teng.insert_many(tstate, _t(vs))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t, st_j, "state")
    assert tstats.dropped.tolist() == [False] * 4 + [True] * 3
    assert (tstats.write_requests[4:] == 0).all()
    assert (tstats.read_requests[4:] > 0).all()


@pytest.mark.parametrize("op", ["insert_many", "insert_batch"])
def test_free_list_reuse_matches_reference(navis, port, dataset, op):
    """Three deleted slots handed to both packages as a reclaimed free
    list: inserts take them (last first) before fresh slots, clear their
    tombstones and free marks and give back n_deleted."""
    eng, state = navis
    teng, tstate = port
    victims = [3, 44, 101]
    state = eng.delete_many(state, jnp.asarray(victims, jnp.int32))
    free_list = np.full(state.store.n_max, -1, np.int32)
    free_list[:3] = victims
    free_mask = np.zeros(state.store.n_max, bool)
    free_mask[victims] = True
    state = dataclasses.replace(
        state, free_list=jnp.asarray(free_list),
        free_count=jnp.int32(3), free_mask=jnp.asarray(free_mask))
    tstate = interop.engine_state_from(state, device="cpu")
    vs = _wave(dataset, 5, seed=31)
    stats, st_j = getattr(eng, op)(state, jnp.asarray(vs))
    tstats, st_t = getattr(teng, op)(tstate, _t(vs))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t, st_j, "state")
    assert st_t.free_count == 0 and st_t.n_deleted == 0
    assert st_t.store.count == tstate.store.count + 2


# ---------------------------------------------------------------------------
# properties of the port alone
# ---------------------------------------------------------------------------

def test_insert_many_single_insert_matches_sequential(port, dataset):
    """A wave of one has no conflicts: the merged cache is the sequential
    insert's, bit for bit, and the new vertex has the same neighbors."""
    teng, tstate = port
    one = _t(_wave(dataset, 1))
    _, st_m = teng.insert_many(tstate, one)
    _, st_s = teng.insert_batch(tstate, one)
    assert st_m.store.count == st_s.store.count
    _same_tree(st_m.cache, st_s.cache, "cache")
    new_id = tstate.store.count
    assert sorted(st_m.store.edges[new_id].tolist()) == \
        sorted(st_s.store.edges[new_id].tolist())


@pytest.mark.parametrize("op", ["insert", "insert_batch", "insert_many",
                                "delete", "delete_many", "search",
                                "search_batch", "search_many"])
def test_operations_leave_input_state_unchanged(port, dataset, op):
    teng, tstate = port
    before = interop.to_numpy(tstate)
    vs = _t(_wave(dataset, 3, seed=41))
    qs = _t(dataset["queries"][:3])
    ids = np.asarray(tstate.ent.ids)
    member = int(ids[ids >= 0][1])
    args = {"insert": (vs[0],), "insert_batch": (vs,), "insert_many": (vs,),
            "delete": (member,), "delete_many": ([member, 7],),
            "search": (qs[0],), "search_batch": (qs,),
            "search_many": (qs,)}[op]
    getattr(teng, op)(tstate, *args)
    _same_dicts(interop.to_numpy(tstate), before, "input state")


def test_search_many_ids_equal_search_batch(port, dataset):
    """The fan-out answers as the sequential path does (the cache changes
    only the I/O charged, never the results)."""
    teng, tstate = port
    qs = _t(dataset["queries"][:12])
    ids_m, d_m, _, _ = teng.search_many(tstate, qs)
    ids_s, d_s, _, _ = teng.search_batch(tstate, qs)
    assert torch.equal(ids_m, ids_s)
    assert torch.equal(d_m, d_s)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2 ** 20), drift=st.floats(0.0, 0.5))
def test_insert_many_keeps_batch_recall(port, dataset, seed, drift):
    """The reference's fan-out property on the port: the same wave
    through ``insert_many`` and ``insert_batch`` gives the same count,
    well-formed graphs, and held-out recall within 0.05 of the sequential
    graph's.  (No per-example deadline: the property is recall, not
    time.)"""
    teng, tstate = port
    newv = _t(_wave(dataset, 12, seed=seed, drift=drift))
    _, st_m = teng.insert_many(tstate, newv)
    _, st_s = teng.insert_batch(tstate, newv)
    assert st_m.store.count == st_s.store.count
    _well_formed(st_m)
    _well_formed(st_s)
    qs = _t(dataset["queries"])
    truth = brute_force_topk(qs, st_s.store.vectors, st_s.store.count, 10)
    r_m = recall_at_k(teng.search_batch(st_m, qs)[0], truth)
    r_s = recall_at_k(teng.search_batch(st_s, qs)[0], truth)
    assert r_m >= r_s - 0.05, (r_m, r_s)
