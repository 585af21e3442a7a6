"""FreshDiskANN's buffered update path on the port against the reference,
on the conftest ``freshdiskann`` index: buffered ``insert`` /
``insert_batch`` / ``insert_many`` (appends, no I/O, drops past the
buffer), searches that merge exact buffer hits (virtual ids ``n_max +
slot``), ``needs_merge`` and ``merge`` (sequential in-place inserts
through one shared page buffer, then the stream rewrite), every field
exact; and the chunked merge the buffer scan uses, against one stable
merge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import ops, ref
from test_torch_engine import _ids_equal, _same, _same_tree
from test_torch_insert import _t, _wave
from test_torch_presets import adopt, spec_of
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def port(freshdiskann):
    eng, state = freshdiskann
    return (interop.engine_from(eng, device="cpu"),
            interop.engine_state_from(state, device="cpu"))


@pytest.fixture(scope="module")
def buffered(freshdiskann, port, dataset):
    """Both packages after buffering the first 72 vectors of a stream
    (6% of 1,200: exactly the merge threshold) through ``insert_many``."""
    eng, state = freshdiskann
    teng, tstate = port
    vs = _wave(dataset, 72, seed=31)
    stats, st = eng.insert_many(state, jnp.asarray(vs))
    tstats, tst = teng.insert_many(tstate, _t(vs))
    return stats, st, tstats, tst, vs


def test_build_shared_matches_reference(freshdiskann, dataset,
                                        shared_bundle):
    """``build(shared=)`` of the packed, buffered preset equals the
    conftest fixture's reference build."""
    _, state = freshdiskann
    _, _, _, tstate = adopt(spec_of("freshdiskann"), dataset, shared_bundle)
    _same_tree(tstate, state, "state")


def test_buffered_insert_many_matches_reference(buffered, port):
    """Appends only: no I/O, no drop, the buffer and its count equal the
    reference's, the graph untouched."""
    stats, st, tstats, tst, _ = buffered
    _same_tree(tstats, stats, "OpStats")
    _same_tree(tst, st, "state")
    assert tst.buf_count == 72
    assert int(tstats.read_requests.sum() + tstats.write_requests.sum()) == 0
    _same(tst.store.edges, port[1].store.edges)


def test_buffered_insert_and_batch_match_reference(freshdiskann, port,
                                                   dataset):
    """``insert`` returns an all-false page map; ``insert_batch`` past the
    buffer's capacity (128) drops the rest; ``insert_many`` skips padding
    lanes."""
    eng, state = freshdiskann
    teng, tstate = port
    v = _wave(dataset, 1, seed=32)[0]
    stats, st, seen = eng.insert(state, jnp.asarray(v))
    tstats, tst, tseen = teng.insert(tstate, _t(v))
    _same_tree(tstats, stats, "insert OpStats")
    _same_tree(tst, st, "insert state")
    _same(tseen, seen, "page map")
    assert not bool(tseen.any())
    vs = _wave(dataset, 130, seed=33)
    stats, st = eng.insert_batch(state, jnp.asarray(vs))
    tstats, tst = teng.insert_batch(tstate, _t(vs))
    _same_tree(tstats, stats, "insert_batch OpStats")
    _same_tree(tst, st, "insert_batch state")
    assert tstats.dropped.tolist() == [False] * 128 + [True] * 2
    ok = np.arange(8) % 3 != 1
    stats, st = jax.jit(eng._insert_many)(state, jnp.asarray(vs[:8]),
                                          jnp.asarray(ok))
    tstats, tst = teng.insert_many(tstate, _t(vs[:8]), _t(ok))
    _same_tree(tstats, stats, "masked insert_many OpStats")
    _same_tree(tst, st, "masked insert_many state")
    assert tst.buf_count == int(ok.sum())


def test_search_with_buffer_hits_matches_reference(freshdiskann, port,
                                                  buffered, dataset):
    """Searching for buffered vectors finds them at their virtual ids,
    through ``search_many`` (snapshot) and ``search_batch`` (threaded):
    ids, distances, OpStats and the whole state as the reference's."""
    eng, teng = freshdiskann[0], port[0]
    _, st, _, tst, vs = buffered
    q = np.concatenate([vs[:6], np.array(dataset["queries"][:6])])
    for op in ("search_many", "search_batch"):
        ids, dists, stats, st2 = getattr(eng, op)(st, jnp.asarray(q))
        tids, tdists, tstats, tst2 = getattr(teng, op)(tst, _t(q))
        _ids_equal(tids.numpy(), ids, q, np.asarray(st.store.vectors), op)
        np.testing.assert_allclose(tdists.numpy(), dists, rtol=0, atol=1e-4)
        _same_tree(tstats, stats, f"{op} OpStats")
        _same_tree(tst2, st2, f"{op} state")
    n_max = tst.store.n_max
    assert tids[:6, 0].tolist() == list(range(n_max, n_max + 6))


def test_needs_merge_and_merge_match_reference(freshdiskann, port, buffered,
                                               dataset):
    """The threshold (6% of the index, in float32) is met exactly at 72;
    ``merge`` inserts the 72 buffered vectors in place through one page
    buffer, charges the stream rewrite and empties the buffer: stats and
    every state field exact, the graph grown by 72 with its invariants."""
    from repro_torch.core import check_invariants
    eng, state = freshdiskann
    teng, _ = port
    _, st, _, tst, _ = buffered
    assert bool(eng.needs_merge(st)) and teng.needs_merge(tst)
    for n in (0, 71):
        vs = _wave(dataset, n, seed=34) if n else np.zeros((0, 48),
                                                            np.float32)
        _, s_j = eng.insert_many(state, jnp.asarray(vs))
        _, s_t = teng.insert_many(port[1], _t(vs))
        assert bool(eng.needs_merge(s_j)) == teng.needs_merge(s_t) is False
    stats, merged = eng.merge(st)
    tstats, tmerged = teng.merge(tst)
    _same_tree(tstats, stats, "merge OpStats")
    _same_tree(tmerged, merged, "merged state")
    assert tmerged.store.count == tst.store.count + 72
    assert tmerged.buf_count == 0 and int(tstats.write_requests) > 0
    assert all(check_invariants(tmerged.store).values())


@pytest.mark.parametrize("p,q,seed", [(10, 4096, 0), (10, 1500, 1),
                                      (40, 2000, 2), (10, 200, 3)])
def test_chunked_merge_equals_one_stable_merge(p, q, seed):
    """Chunks of at most 1024 - P merged in order equal one stable merge
    of pool and block: distances on a coarse grid, and a run of equal
    smallest keys planted across every chunk border (so the answer's
    order among them is their order in the block)."""
    rng = np.random.default_rng(seed)
    lanes = 3
    pool_d = np.sort(np.round(rng.random((lanes, p)) * 8) / 2 + 0.5, 1)
    pool_d = pool_d.astype(np.float32)
    pool_i = rng.integers(0, 10 ** 6, (lanes, p)).astype(np.int32)
    pool_d[:, -2:], pool_i[:, -2:] = np.float32(3.4e38), -1
    new_d = (np.round(rng.random((lanes, q)) * 8) / 2 + 0.5).astype(
        np.float32)
    new_i = np.arange(q, dtype=np.int32)[None].repeat(lanes, 0) + 5000
    new_d[:, -q // 5:], new_i[:, -q // 5:] = np.float32(3.4e38), -1
    step = ops.POOL_MERGE_MAX - p
    borders = list(range(step, q, step))
    for b in borders:
        new_d[:, b - 2:b + 2] = 0.0
        new_i[:, b - 2:b + 2] = 5000 + np.arange(b - 2, b + 2)
    args = [torch.from_numpy(a) for a in (pool_d, pool_i, new_d, new_i)]
    got_d, got_i = ops.pool_merge_chunked(*args)
    want_d, want_i = ref.pool_merge_ref(*args)
    _same(got_i, want_i, "ids")
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    for b in range(lanes):
        _, ji = jref.pool_merge_ref(*[jnp.asarray(a[b]) for a in
                                      (pool_d, pool_i, new_d, new_i)])
        _same(got_i[b], ji, f"lane {b} against the reference")
    if borders:       # the planted ties lead, in block order
        planted = [5000 + i for b in borders for i in range(b - 2, b + 2)]
        assert got_i[0, :len(planted)].tolist() == planted[:p]
