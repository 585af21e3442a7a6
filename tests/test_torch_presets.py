"""The paper's baselines on the port against the reference, on the conftest
index: ``odinann``, ``odinann_cache`` (packed layout, full rerank with the
CASR classifier), ``layout_only`` (decoupled, full rerank), ``sel_vec``
(decoupled, CASR, static entrance, no cache) and ``navis`` with the
bitmap visited sets.  Each adopts the conftest ``navis`` build's bundle
(``build(shared=...)``) in both packages; then search waves, sequential
searches, an insert wave and sequential inserts must leave every
``EngineState`` field and every OpStats equal to the reference's
(distances to 1e-4: the rerank sums run in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import preset as jpreset
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import Engine
from test_torch_engine import _ids_equal, _same_dicts, _same_tree
from test_torch_insert import _t, _wave
from _torch_threads import one_torch_thread  # noqa: F401

# (preset, overrides): the four other in-place presets, and navis with
# the reference's bitmap visited sets
CASES = [("odinann", {}), ("odinann_cache", {}), ("layout_only", {}),
         ("sel_vec", {}), ("navis", {"visited_impl": "bitmap"})]
WAVE = 20


def spec_of(name, **overrides):
    """The conftest engine configuration of preset ``name``."""
    return jpreset(name, dim=48, r=16, n_max=1600, e_search=40, e_pos=48,
                   pq_m=24, cache_capacity_pages=256, max_hops=64,
                   buffer_max=128, **overrides)


def adopt(spec, dataset, shared_bundle):
    """Both packages' engines of ``spec``, each adopting the conftest
    bundle: (reference engine, its state, port engine, its state)."""
    eng = JEngine(spec)
    state = eng.build(jax.random.PRNGKey(2), dataset["vecs"],
                      shared=shared_bundle)
    teng = Engine(interop.spec_from(spec), device="cpu")
    tstate = teng.build(jr.PRNGKey(2), _t(dataset["vecs"]),
                        shared=interop.bundle_from(shared_bundle, "cpu"))
    return eng, state, teng, tstate


@pytest.fixture(scope="module", params=CASES,
                ids=[n + ("_bitmap" if o else "") for n, o in CASES])
def pair(request, dataset, shared_bundle):
    name, overrides = request.param
    return adopt(spec_of(name, **overrides), dataset, shared_bundle)


def test_build_shared_matches_reference(pair):
    """The adopted index, re-paged for the preset's layout: graph, pages,
    codes, entrance, cache and every counter equal the reference's."""
    eng, state, teng, tstate = pair
    _same_tree(tstate, state, "state")
    assert teng.codec is not None and tstate.store.count == 1200


def test_search_many_two_waves_match_reference(pair, dataset):
    """Two waves of 20: ids exact, distances to 1e-4, per-query OpStats
    (the reclassified vector bytes inside read_bytes), the merged cache
    and the search counters (useful and wasted vector bytes apart)
    exact."""
    eng, state, teng, tstate = pair
    qs = np.array(dataset["queries"][:2 * WAVE])
    vectors = np.asarray(state.store.vectors)
    for w in range(2):
        q = qs[w * WAVE:(w + 1) * WAVE]
        ids, dists, stats, state = eng.search_many(state, jnp.asarray(q))
        tids, tdists, tstats, tstate = teng.search_many(tstate, _t(q))
        _ids_equal(tids.numpy(), ids, q, vectors, f"wave {w}")
        np.testing.assert_allclose(tdists.numpy(), dists, rtol=0, atol=1e-4)
        _same_tree(tstats, stats, f"wave {w} OpStats")
        _same_tree(tstate.cache, state.cache, f"wave {w} cache")
        _same_tree(tstate.ctr_search, state.ctr_search,
                   f"wave {w} ctr_search")
    assert int(state.ctr_search.useful_vec_bytes_read) > 0


def test_search_batch_matches_reference(pair, dataset):
    """Eight sequential searches through the threaded cache."""
    eng, state, teng, tstate = pair
    qs = np.array(dataset["queries"][:8])
    ids, dists, stats, st_j = eng.search_batch(state, jnp.asarray(qs))
    tids, tdists, tstats, st_t = teng.search_batch(tstate, _t(qs))
    _ids_equal(tids.numpy(), ids, qs, np.asarray(state.store.vectors),
               "search_batch")
    np.testing.assert_allclose(tdists.numpy(), dists, rtol=0, atol=1e-4)
    _same_tree(tstats, stats, "OpStats")
    _same_tree(st_t, st_j, "state")


def test_insert_many_matches_reference(pair, dataset):
    """An insert wave of 16: the seeks (full rerank or CASR, classifier on
    the snapshot), the commits (packed page rewrites or decoupled
    relocations) and the cache, every field and the per-insert OpStats
    exact; the input state unchanged."""
    eng, state, teng, tstate = pair
    before = interop.to_numpy(tstate)
    vs = _wave(dataset, 16, seed=21)
    stats, st = eng.insert_many(state, jnp.asarray(vs))
    tstats, tst = teng.insert_many(tstate, _t(vs))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(tst, st, "state")
    _same_dicts(interop.to_numpy(tstate), before, "input state")
    assert int(np.asarray(stats.write_requests).min()) > 0


def test_insert_batch_matches_reference(pair, dataset):
    """Four sequential inserts (the classifier on the post-commit store)."""
    eng, state, teng, tstate = pair
    vs = _wave(dataset, 4, seed=22)
    stats, st = eng.insert_batch(state, jnp.asarray(vs))
    tstats, tst = teng.insert_batch(tstate, _t(vs))
    _same_tree(tstats, stats, "OpStats")
    _same_tree(tst, st, "state")


def test_packed_insert_keeps_the_slots_initial_page_live(pair, dataset):
    """A reference quirk the port keeps (ROADMAP queue 3): the packed
    commit moves the new slot to a fresh page but does not release the
    page the initial placement gave that slot, so ``page_live`` counts it
    on both; the decoupled relocation releases it."""
    eng, state, teng, tstate = pair
    slot = tstate.store.count
    old = int(tstate.store.edge_page[slot])
    _, tst = teng.insert_many(tstate, _t(_wave(dataset, 1, seed=23)))
    held = int((tst.store.edge_page == old).sum())
    if teng.spec.layout == "packed":
        assert int(tst.store.edge_page[slot]) != old
        assert int(tst.store.page_live[old]) == held + 1
    else:
        assert int(tst.store.page_live[old]) == held
