"""The CASR classifier and the warm-up calibration on the port against the
reference: ``casr_stop_point`` lane for lane (the port reads it off one
``casr_rerank`` call at s = 1 as min(rounds * s, valid)) on real search
and seek pools of the conftest ``navis`` index, on pools with tombstone
holes, with fewer than k valid ids, and all -1; ``calibrate_group_size``
and ``Engine.calibrate`` (one frozen wave per pool size against the
reference's threaded traversals)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as JEngine
from repro.core import casr as jcasr
from repro.core import pq as jpq
from repro.core import search as jsearch
from repro.core.iomodel import IOCounters as JCounters
from repro_torch import interop
from repro_torch.core import casr as tcasr
from repro_torch.core import pq as tpq
from repro_torch.core import search as tsearch
from repro_torch.core.iomodel import IOCounters
from test_torch_engine import _same
from test_torch_insert import _t, _wave
from _torch_threads import one_torch_thread  # noqa: F401

LANES = 24


@pytest.fixture(scope="module")
def port(navis):
    eng, state = navis
    return (interop.engine_from(eng, device="cpu"),
            interop.engine_state_from(state, device="cpu"))


@pytest.fixture(scope="module")
def pools(port, dataset):
    """Real pools of the port's frozen traversal (equal to the
    reference's, ``tests/test_torch_engine.py``): search pools (e_search)
    for queries, seek pools (e_pos) for an insert stream."""
    teng, tstate = port
    spec = teng.spec
    qs = np.array(dataset["queries"][:LANES])
    vs = _wave(dataset, LANES, seed=41)
    out = {}
    for name, x, size in (("search", qs, spec.e_search),
                          ("seek", vs, spec.e_pos)):
        tx = _t(x)
        lut = tpq.adc_lut(teng.codec, tx)
        entries, _ = teng._entries(tstate, lut)
        res = tsearch.disk_traverse(
            tstate.store, spec.lspec, lut, tstate.codes, tstate.cache,
            IOCounters.zeros((LANES,), "cpu"), entries, pool_size=size,
            beam_width=spec.beam_width, max_hops=spec.max_hops)
        out[name] = (x, res.pool_ids.numpy())
    return out


def _variant(pool, kind, rng):
    pool = pool.copy()
    if kind == "holes":           # tombstoned candidates anywhere
        pool[rng.random(pool.shape) < 0.25] = -1
    elif kind == "few":           # fewer than k valid ids (a -1 tail)
        pool[:, 6:] = -1
    elif kind == "lead_holes":    # holes before the first valid id
        pool[:, :3] = -1
        pool[:, 12] = -1
    pool[-1] = -1                 # and one all -1 lane
    return pool


@pytest.mark.parametrize("which", ["search", "seek"])
@pytest.mark.parametrize("kind", ["real", "holes", "few", "lead_holes"])
@pytest.mark.parametrize("s", [1, 4])
def test_stop_point_matches_reference(navis, pools, which, kind, s):
    """Lane for lane, at s = 1 (the classifier) and s = 4."""
    eng, state = navis
    x, pool = pools[which]
    pool = _variant(pool, kind, np.random.default_rng(len(kind) + s))
    k = eng.spec.k
    vectors = state.store.vectors
    want = jax.vmap(lambda q, p: jcasr.casr_stop_point(
        q, vectors, p, k=k, s=s))(jnp.asarray(x), jnp.asarray(pool))
    got = tcasr.casr_stop_point(_t(x), _t(np.asarray(vectors)), _t(pool),
                                k=k, s=s)
    _same(got, want, f"{which} {kind} s={s}")
    assert int(got[-1]) == 0


def test_stop_point_is_not_n_loaded_with_holes(navis, pools):
    """Why the port reads rounds, not ``n_loaded``: with tombstone holes
    the reference's count covers hole positions that CASR's loads skip."""
    eng, state = navis
    x, pool = pools["search"]
    pool = _variant(pool, "holes", np.random.default_rng(9))
    vectors = _t(np.asarray(state.store.vectors))
    from repro_torch.kernels import ops
    n_loaded = ops.casr_rerank(_t(x), vectors, _t(pool), k=eng.spec.k,
                               s=1)[4]
    stop = tcasr.casr_stop_point(_t(x), vectors, _t(pool), k=eng.spec.k)
    assert bool((stop >= n_loaded).all()) and bool((stop > n_loaded).any())


def test_calibrate_group_size_matches_reference(navis, pools):
    eng, state = navis
    for which in ("search", "seek"):
        x, pool = pools[which]
        want = jcasr.calibrate_group_size(
            jax.random.PRNGKey(0), state.store.vectors, jnp.asarray(pool),
            jnp.asarray(x), k=eng.spec.k)
        got = tcasr.calibrate_group_size(
            _t(np.asarray(state.store.vectors)), _t(pool), _t(x),
            k=eng.spec.k)
        assert got == want, which


def test_calibrate_frozen_wave_matches_reference(navis, port, dataset):
    """``Engine.calibrate`` on 40 warm-up queries: the frozen wave's pools
    equal the reference's threaded traversals (the cache it threads does
    not change ids), and both install the same s_search and s_pos.  The
    reference runs on a fresh engine, so the session fixture's spec stays
    as it is."""
    eng, state = navis
    teng, tstate = port
    qs = np.array(dataset["queries"])
    spec = eng.spec

    def threaded(q, pool_size):
        lut = jpq.adc_lut(eng.codec, q)
        entries, _ = eng._entries(state, lut)
        return jsearch.disk_traverse(
            state.store, spec.lspec, lut, state.codes, state.cache,
            JCounters.zeros(), entries, pool_size=pool_size,
            beam_width=spec.beam_width, max_hops=spec.max_hops).pool_ids

    want = jax.jit(lambda q: jax.lax.map(
        lambda x: threaded(x, spec.e_pos), q))(jnp.asarray(qs[:8]))
    tq = _t(qs[:8])
    lut = tpq.adc_lut(teng.codec, tq)
    entries, _ = teng._entries(tstate, lut)
    got = tsearch.disk_traverse(
        tstate.store, spec.lspec, lut, tstate.codes, tstate.cache,
        IOCounters.zeros((8,), "cpu"), entries, pool_size=spec.e_pos,
        beam_width=spec.beam_width, max_hops=spec.max_hops).pool_ids
    _same(got, want, "pools")

    ref_eng = JEngine(spec)
    ref_eng.codec, ref_eng._sym = eng.codec, eng._sym
    want_spec = ref_eng.calibrate(state, jnp.asarray(qs))
    port_eng = interop.engine_from(eng, device="cpu")
    got_spec = port_eng.calibrate(tstate, _t(qs))
    assert (got_spec.s_search, got_spec.s_pos) == \
        (want_spec.s_search, want_spec.s_pos)
    assert port_eng.spec is got_spec and eng.spec is spec
    assert teng.spec.s_search == spec.s_search
