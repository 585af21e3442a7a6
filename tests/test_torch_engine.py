"""The slice as a whole: the port's search fan-out on the reference's own
``navis`` index (the conftest fixture, brought across by ``interop``).

Every test that needs the fixture lives in this file, so the JAX build
runs once per worker for it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casr as jcasr
from repro.core import pq as jpq
from repro.core import search as jsearch
from repro.core.iomodel import IOCounters as JCounters
from repro_torch import interop
from repro_torch.core import casr as tcasr
from repro_torch.core import pq as tpq
from repro_torch.core import search as tsearch
from repro_torch.core.iomodel import IOCounters
from _torch_threads import one_torch_thread  # noqa: F401


WAVE = 20


@pytest.fixture(scope="module")
def port(navis):
    eng, state = navis
    return (interop.engine_from(eng, device="cpu"),
            interop.engine_state_from(state, device="cpu"))


def _same(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64), what)


def _same_dicts(g, w, what):
    assert set(g) == set(w), what
    for name in w:
        if isinstance(w[name], dict):
            _same_dicts(g[name], w[name], f"{what}.{name}")
        else:
            _same(g[name], w[name], f"{what}.{name}")


def _same_tree(got, want, what):
    """Every field of two state objects (either package) equal as ints."""
    _same_dicts(interop.to_numpy(got), interop.to_numpy(want), what)


def _ids_equal(got, want, q, vectors, what):
    """ids exact; on a mismatch, show the two ids' exact distances."""
    got, want = np.asarray(got), np.asarray(want)
    if (got == want).all():
        return
    rows, cols = np.nonzero(got != want)
    notes = []
    for r, c in zip(rows[:5], cols[:5]):
        d = [float(((vectors[i] - q[r]) ** 2).sum()) if i >= 0 else None
             for i in (got[r, c], want[r, c])]
        notes.append(f"query {r} slot {c}: port id {got[r, c]} d={d[0]}, "
                     f"reference id {want[r, c]} d={d[1]}")
    pytest.fail(f"{what}: ids differ\n" + "\n".join(notes))


def test_interop_roundtrip(navis, port):
    """Every field of the reference's state comes across unchanged."""
    _, state = navis
    _same_tree(port[1], state, "state")


def test_one_wave_stages_match_reference(navis, port, dataset):
    """One wave through entrance_search, disk_traverse (frozen cache) and
    casr_rerank: entries, pools, hops, counters, traces and the reranked
    top-k per lane equal the reference's vmap of the same stages."""
    eng, state = navis
    teng, tstate = port
    spec = eng.spec
    qs = np.array(dataset["queries"][:8])

    def ref_one(q):
        lut = jpq.adc_lut(eng.codec, q)
        entries, e_ent, _ = jsearch.entrance_search(
            state.ent, lut, state.codes, n_entry=spec.n_entry,
            pool_size=spec.ent_pool)
        res = jsearch.disk_traverse(
            state.store, spec.lspec, lut, state.codes, state.cache,
            JCounters.zeros(), entries, pool_size=spec.e_search,
            beam_width=spec.beam_width, max_hops=spec.max_hops,
            frozen_cache=True)
        cres = jcasr.casr_rerank(state.store, spec.lspec, q, res.pool_ids,
                                 res.counters, k=spec.k, s=spec.s_search)
        return entries, e_ent, res, cres

    entries, e_ent, res, cres = jax.jit(jax.vmap(ref_one))(jnp.asarray(qs))

    tq = torch.from_numpy(qs)
    lut = tpq.adc_lut(teng.codec, tq)
    t_entries, t_eent, _ = tsearch.entrance_search(
        tstate.ent, lut, tstate.codes, n_entry=spec.n_entry,
        pool_size=spec.ent_pool)
    _same(t_entries, entries, "entries")
    _same(t_eent, e_ent, "E_ent")
    tres = tsearch.disk_traverse(
        tstate.store, spec.lspec, lut, tstate.codes, tstate.cache,
        IOCounters.zeros((8,), device="cpu"), t_entries, pool_size=spec.e_search,
        beam_width=spec.beam_width, max_hops=spec.max_hops)
    _same(tres.pool_ids, res.pool_ids, "pool ids")
    np.testing.assert_allclose(tres.pool_dists.numpy(), res.pool_dists,
                               rtol=0, atol=1e-4)
    _same(tres.hops, res.hops, "hops")
    _same(tres.trace, res.trace, "trace")
    _same(tres.trace_n, res.trace_n, "trace_n")
    _same_tree(tres.counters, res.counters, "traverse counters")
    _same_tree(tres.page_seen, res.page_seen, "page_seen")

    tc = tcasr.casr_rerank(tstate.store, spec.lspec, tq, tres.pool_ids,
                           tres.counters, k=spec.k, s=spec.s_search)
    vectors = np.asarray(state.store.vectors)
    _ids_equal(tc.topk_ids.numpy(), cres.topk_ids, qs, vectors, "CASR")
    np.testing.assert_allclose(tc.topk_d.numpy(), cres.topk_d, rtol=0,
                               atol=1e-4)
    for name in ("loaded", "n_loaded", "n_groups", "rerank_rounds"):
        _same(getattr(tc, name), getattr(cres, name), name)
    _same_tree(tc.counters, cres.counters, "CASR counters")


def test_search_many_two_waves_match_reference(navis, port, dataset):
    """Two consecutive waves of 20 queries: ids exact, distances to 1e-4
    (the rerank sums run in another order), per-query OpStats, the merged
    cache (the second wave promotes pages, drawing threefry probes) and
    the search counters exact."""
    eng, state = navis
    teng, tstate = port
    qs = np.array(dataset["queries"][:2 * WAVE])
    vectors = np.asarray(state.store.vectors)
    fill0 = int(state.cache.frozen_fill)
    for w in range(2):
        q = qs[w * WAVE:(w + 1) * WAVE]
        ids, dists, stats, state = eng.search_many(state, jnp.asarray(q))
        tids, tdists, tstats, tstate = teng.search_many(
            tstate, torch.from_numpy(q))
        _ids_equal(tids.numpy(), ids, q, vectors, f"wave {w}")
        np.testing.assert_allclose(tdists.numpy(), dists, rtol=0, atol=1e-4)
        _same_tree(tstats, stats, f"wave {w} OpStats")
        _same_tree(tstate.cache, state.cache, f"wave {w} cache")
        _same_tree(tstate.ctr_search, state.ctr_search,
                   f"wave {w} ctr_search")
    assert int(state.cache.frozen_fill) > fill0


def test_search_many_device_default_raises_without_card(navis):
    """The port's engine runs on cuda unless told otherwise."""
    from repro_torch.core import Engine
    eng, _ = navis
    spec = interop.spec_from(eng.spec)
    if torch.cuda.is_available():
        assert Engine(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            Engine(spec)
    assert dataclasses.asdict(spec) == dataclasses.asdict(eng.spec)
