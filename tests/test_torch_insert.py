"""The port's insert path against the reference on the conftest ``navis``
index (brought across by ``interop``): neighbor selection, the wave-commit
helpers, NAVIS-update, the entrance-aware cache admit, a position-seek
wave, and whole ``insert_many`` waves (every ``EngineState`` field and the
per-insert OpStats exact)."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import entrance as jent
from repro.core import insert as jinsert
from repro.core import pq as jpq
from repro.core.iomodel import IOCounters as JCounters
from repro.data import insert_stream
from repro_torch import interop
from repro_torch.core import cache as tcache
from repro_torch.core import entrance as tent
from repro_torch.core import insert as tinsert
from repro_torch.core import pq as tpq
from repro_torch.core.iomodel import IOCounters
from repro_torch.data import insert_stream as t_insert_stream
from test_torch_engine import _same, _same_dicts, _same_tree
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port(navis):
    eng, state = navis
    return (interop.engine_from(eng, device="cpu"),
            interop.engine_state_from(state, device="cpu"))


def _wave(dataset, n, seed=7, drift=0.2):
    """The reference tests' insert stream, as numpy for both packages."""
    return np.array(insert_stream(jax.random.PRNGKey(seed), dataset["cents"],
                                  n, drift=drift))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# neighbor selection and the wave-commit helpers
# ---------------------------------------------------------------------------

class _Casr(NamedTuple):
    loaded: object
    exact_d: object


@pytest.mark.parametrize("p,r,seed", [(48, 16, 0), (64, 48, 1), (100, 96, 2),
                                      (20, 32, 3)])
def test_select_neighbors_matches_reference(p, r, seed):
    """Loaded by exact distance (ties included), then the unloaded rest in
    PQ order: the float32 key ``1e30 + position`` collapses, and the
    stable sort keeps the order."""
    rng = np.random.default_rng(seed)
    lanes = 4
    pool = rng.integers(0, 5000, (lanes, p)).astype(np.int32)
    pool[rng.random((lanes, p)) < 0.15] = -1                  # tombstone holes
    pool[:, p - p // 5:] = -1                                 # padded tail
    loaded = rng.random((lanes, p)) < 0.4
    exact = np.round(rng.random((lanes, p)) * 20).astype(np.float32)
    exact = np.where(loaded, exact, np.float32(3.4e38)).astype(np.float32)
    got = tinsert.select_neighbors(_t(pool), _Casr(_t(loaded), _t(exact)), r)
    for b in range(lanes):
        want = jinsert.select_neighbors(
            jnp.asarray(pool[b]), _Casr(jnp.asarray(loaded[b]),
                                        jnp.asarray(exact[b])), r)
        _same(got[b], want, f"lane {b}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_revalidate_neighbors_matches_reference(navis, port, seed):
    """Self, repeats, tombstoned picks and padding dropped; survivors by
    symmetric-PQ distance (summed in subspace order), stable."""
    eng, state = navis
    tstate = port[1]
    rng = np.random.default_rng(seed)
    r = state.store.r
    nbrs = rng.integers(0, 1200, r).astype(np.int32)
    nbrs[rng.random(r) < 0.2] = -1
    nbrs[3] = nbrs[1]                                         # a repeat
    new_id = 1200 + seed
    nbrs[5] = new_id                                          # self
    tomb = np.zeros(state.store.n_max, bool)
    tomb[nbrs[rng.random(r) < 0.2].clip(0)] = True
    code = np.array(state.codes[17])
    want = jinsert.revalidate_neighbors(
        jnp.asarray(nbrs), jnp.int32(new_id), jnp.asarray(code),
        state.codes, eng._sym, jnp.asarray(tomb))
    got = tinsert.revalidate_neighbors(_t(nbrs), new_id, _t(code),
                                       tstate.codes, port[0]._sym, _t(tomb))
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_charge_rmw_rereads_matches_reference(navis, port, seed):
    """One edge-page read per distinct dirty neighbor page."""
    eng, state = navis
    tstate = port[1]
    rng = np.random.default_rng(seed)
    r = state.store.r
    nbrs = rng.integers(0, 1200, r).astype(np.int32)
    nbrs[rng.random(r) < 0.2] = -1
    nbrs[7] = nbrs[2] ^ 1          # likely the same page as nbrs[2]
    pages = np.asarray(state.store.edge_page)
    dirty = np.zeros(state.store.page_live.shape[0], bool)
    dirty[pages[nbrs[rng.random(r) < 0.5].clip(0)]] = True
    want_c, want_n = jinsert.charge_rmw_rereads(
        JCounters.zeros(), eng.spec.lspec, state.store, jnp.asarray(nbrs),
        jnp.asarray(dirty))
    got_c, got_n = tinsert.charge_rmw_rereads(
        IOCounters.zeros((), "cpu"), eng.spec.lspec, tstate.store, _t(nbrs),
        _t(dirty))
    assert int(got_n) == int(want_n) > 0
    _same_tree(got_c, want_c, "counters")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mark_dirty_pages_matches_reference(navis, port, seed):
    eng, state = navis
    tstate = port[1]
    rng = np.random.default_rng(seed)
    r = state.store.r
    nbrs = rng.integers(0, 1200, r).astype(np.int32)
    nbrs[rng.random(r) < 0.2] = -1
    modified = rng.random(r) < 0.5
    dirty = rng.random(state.store.page_live.shape[0]) < 0.05
    want = jinsert.mark_dirty_pages(jnp.asarray(dirty), state.store,
                                    jnp.int32(40 + seed), jnp.asarray(nbrs),
                                    jnp.asarray(modified))
    got = tinsert.mark_dirty_pages(_t(dirty), tstate.store, 40 + seed,
                                   _t(nbrs), _t(modified))
    _same(got, want)


# ---------------------------------------------------------------------------
# NAVIS-update and the entrance-aware admit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["promote", "promote_after_delete",
                                  "already_member", "above_threshold"])
def test_navis_update_matches_reference(navis, port, case):
    """Algorithm 2 on the fixture's entrance graph: the live-membership
    trigger, E_pos ∩ G_ent then E_ent deduped, reciprocal wiring with the
    symmetric-PQ prune.  ``promote_after_delete`` scrubs a member first
    (a hole the trigger must not count)."""
    eng, state = navis
    teng, tstate = port
    ent_j, ent_t = state.ent, tstate.ent
    ids = np.asarray(ent_j.ids)
    rng = np.random.default_rng(5)
    members = ids[ids >= 0]
    e_pos = np.concatenate([rng.choice(members, 6, replace=False),
                            rng.integers(0, 1200, 42)]).astype(np.int32)
    rng.shuffle(e_pos)
    e_pos[-5:] = -1
    e_ent = np.concatenate([rng.choice(members, 8), [-1] * 24]
                           ).astype(np.int32)
    new_id, count = 1200, 2000
    if case == "promote_after_delete":
        state = eng.delete(state, jnp.int32(int(members[2])))
        tstate = teng.delete(tstate, int(members[2]))
        ent_j, ent_t = state.ent, tstate.ent
    elif case == "already_member":
        new_id = int(members[4])
    elif case == "above_threshold":
        count = 1000
    code = np.array(state.codes[33])
    want = jent.navis_update(ent_j, jnp.int32(new_id), jnp.asarray(code),
                             jnp.asarray(e_pos), jnp.asarray(e_ent),
                             jnp.int32(count), state.codes, eng._sym,
                             r_ent_frac=eng.spec.ent_frac)
    got = tent.navis_update(interop.entrance_from(ent_t, "cpu"), new_id,
                            _t(code), _t(e_pos), _t(e_ent), count,
                            tstate.codes, teng._sym,
                            r_ent_frac=eng.spec.ent_frac)
    _same_tree(got, want, "entrance")
    promoted = int(want.count) > int(ent_j.count)
    assert promoted == (case in ("promote", "promote_after_delete"))
    if promoted:      # a full row was pruned somewhere, or rows had room
        assert (np.asarray(want.edges) == int(ent_j.count)).sum() > 0


@pytest.mark.parametrize("case", ["not_cached", "in_window", "frozen",
                                  "no_page", "lru"])
def test_priority_admit_matches_reference(case):
    """Every CacheState field, the threefry key included: a page goes
    straight to the frozen region (from nothing or from the window), a
    frozen page only gets its stamp refreshed, and only NAVIS pins."""
    rng = np.random.default_rng(3)
    traces = rng.integers(0, 60, (4, 40)).astype(np.int32)
    policy = "lru" if case == "lru" else "navis"
    st_j = jcache.init_cache(400, 30, policy, jax.random.PRNGKey(5))
    _, st_j = jcache.apply_traces(st_j, jnp.asarray(traces))
    status = np.asarray(st_j.status)
    with_status = {"not_cached": 0, "in_window": 1, "frozen": 2}
    page = (int(np.flatnonzero(status == with_status[case])[0])
            if case in with_status else {"no_page": -1, "lru": 7}[case])
    st_t = interop.cache_from(st_j, device="cpu")
    want = jcache.priority_admit(st_j, jnp.int32(page))
    got = tcache.priority_admit(st_t, page)
    _same_tree(got, want, "cache")


# ---------------------------------------------------------------------------
# position seek and insert waves
# ---------------------------------------------------------------------------

def test_position_seek_wave_matches_reference(navis, port, dataset):
    """A batch-first wave of 8 seeks against the frozen snapshot (after
    three deletes, so tombstones punch holes in pools) equals ``jax.vmap``
    of the reference's frozen seek: neighbors, pools, hops, rerank rounds,
    counters, page sets and traces."""
    eng, state = navis
    teng, tstate = port
    spec = eng.spec
    for v in (3, 44, 101):
        state = eng.delete(state, jnp.int32(v))
    tstate = teng.delete_many(tstate, [3, 44, 101])
    vs = _wave(dataset, 8, seed=11)

    def ref_one(v):
        lut = jpq.adc_lut(eng.codec, v)
        entries, _ = eng._entries(state, lut)
        return jinsert.position_seek(
            state.store, spec.lspec, eng.codec, state.codes, state.cache,
            JCounters.zeros(), v, entries, e_pos=spec.e_pos, k=spec.k,
            s=spec.s_pos, beam_width=spec.beam_width,
            max_hops=spec.max_hops, tombstone=state.tombstone,
            frozen_cache=True)

    want = jax.jit(jax.vmap(ref_one))(jnp.asarray(vs))
    tv = _t(vs)
    entries, _ = teng._entries(tstate, tpq.adc_lut(teng.codec, tv))
    got = tinsert.position_seek(
        tstate.store, spec.lspec, teng.codec, tstate.codes, tstate.cache,
        IOCounters.zeros((8,), "cpu"), tv, entries, e_pos=spec.e_pos,
        k=spec.k, s=spec.s_pos, beam_width=spec.beam_width,
        max_hops=spec.max_hops, tombstone=tstate.tombstone)
    for name in ("nbrs", "pool_ids", "hops", "rerank_rounds", "trace",
                 "trace_n"):
        _same(getattr(got, name), getattr(want, name), name)
    _same_tree(got.counters, want.counters, "counters")
    _same_tree(got.page_seen, want.page_seen, "page_seen")
    assert int(np.asarray(want.counters.tombstone_skips).sum()) >= 0


def test_insert_many_wave_matches_reference(navis, port, dataset):
    """A wave of 12 (it promotes an entrance member, so NAVIS-update and
    the priority admit run): every EngineState field — graph, pages,
    codes, entrance, cache, slot tables, counters — and the per-insert
    OpStats equal the reference's; the input state is unchanged."""
    eng, state = navis
    teng, tstate = port
    before = interop.to_numpy(tstate)
    vs = _wave(dataset, 12)
    stats, st = eng.insert_many(state, jnp.asarray(vs))
    tstats, tst = teng.insert_many(tstate, _t(vs))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(tst, st, "state")
    assert int(st.ent.count) > int(state.ent.count)
    _same_dicts(interop.to_numpy(tstate), before, "input state")
    assert set(teng.last_wave_timing) == {"seek_s", "replay_s", "commit_s"}


def test_insert_many_valid_mask_matches_reference(navis, port, dataset):
    """Padding lanes charge no I/O, replay nothing and commit nothing:
    the whole state and the OpStats equal the reference's."""
    eng, state = navis
    teng, tstate = port
    vs = _wave(dataset, 8)
    ok = np.arange(8) < 5
    stats, st = jax.jit(eng._insert_many)(state, jnp.asarray(vs),
                                          jnp.asarray(ok))
    tstats, tst = teng.insert_many(tstate, _t(vs), _t(ok))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(tst, st, "state")
    assert tst.store.count == tstate.store.count + 5
    rr = tstats.read_requests.numpy()
    assert (rr[:5] > 0).all() and (rr[5:] == 0).all()


def test_insert_many_counter_sum_invariant(port, dataset):
    """The insert counters advance by exactly the sum of the per-insert
    OpStats, and nothing is dropped."""
    teng, tstate = port
    stats, st = teng.insert_many(tstate, _t(_wave(dataset, 10)))
    before, after = tstate.ctr_insert, st.ctr_insert
    delta = lambda f: int(getattr(after, f)) - int(getattr(before, f))
    assert int(stats.read_requests.sum()) == delta("read_requests")
    assert int(stats.write_requests.sum()) == delta("write_requests")
    assert int(stats.read_bytes.sum()) == \
        int(after.total_read_bytes()) - int(before.total_read_bytes())
    assert int(stats.write_bytes.sum()) == \
        int(after.total_write_bytes()) - int(before.total_write_bytes())
    assert int(stats.cache_hits.sum()) == delta("cache_hits")
    assert int(stats.cache_misses.sum()) == delta("cache_misses")
    assert not bool(stats.dropped.any())


def test_insert_stream_shapes_and_drift(dataset):
    """The port's stream draws from the same mixture: shape, device, and a
    drift that moves the vectors off the centres."""
    cents = _t(dataset["cents"])
    gen = torch.Generator().manual_seed(3)
    v0 = t_insert_stream(gen, cents, 64)
    v1 = t_insert_stream(torch.Generator().manual_seed(3), cents, 64,
                         drift=0.0)
    assert v0.shape == (64, cents.shape[1]) and v0.dtype == torch.float32
    assert torch.equal(v0, v1)
    near = torch.cdist(v0, cents).min(1).values.mean()
    far = torch.cdist(t_insert_stream(torch.Generator().manual_seed(3),
                                      cents, 64, drift=3.0),
                      cents).min(1).values.mean()
    assert far > near


def test_insert_next_to_vertex_zero_moves_its_pointer(navis, port, dataset):
    """An insert that rewrites vertex 0's edgelist: the port moves vertex
    0's pointer onto the fresh page that ``page_live`` now counts it on;
    the reference keeps the old pointer (its masked relocation slots
    rewrite vertex 0's entry, ROADMAP queue 3).  Every other store field,
    and the cache, equal the reference's."""
    eng, state = navis
    teng, tstate = port
    rng = np.random.default_rng(0)
    v = (np.asarray(dataset["vecs"][0]) +
         0.05 * rng.standard_normal(state.store.dim)).astype(np.float32)
    _, st = eng.insert_many(state, jnp.asarray(v[None]))
    _, tst = teng.insert_many(tstate, _t(v[None]))
    new_id = tstate.store.count
    assert 0 in tst.store.edges[new_id].tolist()
    fresh = int(tst.store.edge_page[new_id])
    assert int(tst.store.edge_page[0]) == fresh
    assert int(st.store.edge_page[0]) == int(state.store.edge_page[0])
    got, want = interop.to_numpy(tst.store), interop.to_numpy(st.store)
    got["edge_page"][0] = want["edge_page"][0]
    _same_dicts(got, want, "store")
    _same_tree(tst.cache, st.cache, "cache")
