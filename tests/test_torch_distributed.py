"""The port's sharded engine (``repro_torch.core.distributed``) against the
reference's ``repro.core.distributed``.

One module fixture builds the reference's sharded state in-process (N
512, D 32, 4 shards of 128, the reference test's spec with ``ent_frac``
0.10); the port takes it across with ``interop.sharded_state_from``.  At
S = 1 the port is held against the reference's real ``make_sharded_search``
/ ``make_sharded_insert`` on the 1x1 smoke mesh; at S = 4 against the
reference's per-shard ``search_many`` / ``search_batch`` /
``insert_many(valid=)`` / ``insert`` and its merge restated in numpy
(``distributed.py:120-137``).  Ids, counters and every state field are
exact, distances within 1e-3.  Then the merge's tie order against
``lax.top_k``, the global-id collision past ``n_per``, two gloo ranks
against one process, ``state_shapes`` on the meta device, and
``dryrun``'s collectives against those of the reference's compiled
sharded search and insert on 4 fake devices.
"""
import json
import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import Engine as JEngine
from repro.core import distributed as jdist
from repro.core import preset as jpreset
from repro.launch.mesh import make_smoke_mesh
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import Engine as TEngine
from repro_torch.core import brute_force_topk, check_invariants, recall_at_k
from repro_torch.core import distributed as tdist
from repro_torch.core.layout import page_budget
from repro_torch.launch import mesh as PM
from test_torch_engine import _same, _same_dicts, _same_tree
import _torch_dist_worker
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N, D, S, PER = 512, 32, 4, 128
N_MAX = PER + 16            # the reference test's headroom for inserts
INF = np.float32(3.4e38)


def _spec(name="navis"):
    return jpreset(name, dim=D, r=12, n_max=N_MAX, e_search=32, e_pos=40,
                   pq_m=16, cache_capacity_pages=64, max_hops=48,
                   buffer_max=32, ent_frac=0.10)


def _blobs(rng, cents, n, shift=0.0):
    a = rng.integers(0, cents.shape[0], n)
    return (cents[a] + shift + rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def sharded():
    """The reference's sharded build, and the port's engine and states
    taken across from it."""
    rng = np.random.default_rng(0)
    cents = (rng.standard_normal((8, D)) * 3.0).astype(np.float32)
    vecs = _blobs(rng, cents, N)
    eng = JEngine(_spec())
    sstate = jdist.build_sharded_state(eng, jax.random.PRNGKey(2),
                                       jnp.asarray(vecs), S)
    return dict(eng=eng, sstate=sstate, vecs=vecs, cents=cents,
                queries=_blobs(rng, cents, 16),
                inserts=_blobs(rng, cents, 10, shift=0.3),
                teng=interop.engine_from(eng, device="cpu"),
                tstates=interop.sharded_state_from(sstate, device="cpu"))


def _shard(sstate, s):
    return jax.tree.map(lambda x: x[s], sstate)


def _t(x):
    return torch.from_numpy(np.array(x))


def _merge_np(ids, dists, n_per):
    """The reference's globalise + merge (distributed.py:120-137) in numpy
    on per-shard results [S, Q, k]."""
    ids, dists = np.asarray(ids), np.asarray(dists)
    s, q, k = ids.shape
    shard = np.arange(s)[:, None, None]
    gids = np.where(ids >= 0, ids + shard * n_per, -1)
    d = np.where(ids >= 0, dists, INF).astype(np.float32)
    d = d.transpose(1, 0, 2).reshape(q, s * k)
    gids = gids.transpose(1, 0, 2).reshape(q, s * k)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(d, order, 1)
    return np.where(d < INF, np.take_along_axis(gids, order, 1), -1), d


def _same_shard(got, want, before, what):
    """Every field exact but one known reference fault (ROADMAP queue 3,
    ``test_insert_next_to_vertex_zero_moves_its_pointer``): where an
    insert rewrote vertex 0's edgelist, the port moved vertex 0's pointer
    onto a fresh page of this wave and the reference kept the old one."""
    g, w = interop.to_numpy(got), interop.to_numpy(want)
    old = int(before.store.edge_page[0])
    if g["store"]["edge_page"][0] != w["store"]["edge_page"][0]:
        assert w["store"]["edge_page"][0] == old, what
        assert before.store.next_page <= g["store"]["edge_page"][0] < \
            got.store.next_page, what
        g["store"]["edge_page"][0] = old
    _same_dicts(g, w, what)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-3, err_msg=what)


# ---------------------------------------------------------------------------
# routing and the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ids,n_shards,bucket", [
    (list(range(8)), 8, 4),                       # the reference test's
    ([0, 4, 8, 12, 1, 5, 3, 16, 7], 4, 2),        # shard 0 overflows
    ([9, 2, 6], 4, 3),                            # padding only
])
def test_route_inserts_matches_reference(ids, n_shards, bucket):
    """Owner = id % S in input order, buckets padded, entries past the
    bucket dropped: the same routed vectors and mask as the reference."""
    vs = np.random.default_rng(1).standard_normal(
        (len(ids), D)).astype(np.float32)
    want_v, want_ok = jdist.route_inserts(jnp.asarray(vs),
                                          jnp.asarray(ids), n_shards, bucket)
    got_v, got_ok = tdist.route_inserts(_t(vs), ids, n_shards, bucket,
                                        device="cpu")
    assert got_v.dtype == torch.float32 and got_ok.dtype == torch.bool
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    owners = [i % n_shards for i in ids]
    assert len(ids) - int(got_ok.sum()) == sum(
        max(0, owners.count(s) - bucket) for s in set(owners))


def test_build_sharded_state_matches_reference(sharded):
    """One global codec (atol 1e-4, the build test's grade), every shard
    well formed, and each shard's recall within 0.02 of the reference
    shard's (the build's known deviation)."""
    eng, vecs, qs = sharded["eng"], sharded["vecs"], sharded["queries"]
    teng = TEngine(sharded["teng"].spec, device="cpu")
    states = tdist.build_sharded_state(teng, jr.PRNGKey(2), _t(vecs), S)
    np.testing.assert_allclose(teng.codec.codebooks.numpy(),
                               np.asarray(eng.codec.codebooks), atol=1e-4)
    assert len(states) == S
    for s, st in enumerate(states):
        inv = check_invariants(st.store)
        assert all(inv.values()), (s, inv)
        assert st.store.count == PER and st.store.n_max == N_MAX
        mine = vecs[s * PER:(s + 1) * PER]
        truth = brute_force_topk(_t(qs), _t(mine), PER, 10)
        ids, _, _, _ = teng.search_many(st, _t(qs))
        want, _, _, _ = eng.search_many(_shard(sharded["sstate"], s),
                                        jnp.asarray(qs))
        got_r = recall_at_k(ids, truth)
        want_r = recall_at_k(_t(want), truth)
        assert abs(got_r - want_r) <= 0.02, (s, got_r, want_r)


# ---------------------------------------------------------------------------
# S = 1: the reference's real sharded functions on the 1x1 mesh
# ---------------------------------------------------------------------------

def test_sharded_search_and_insert_at_one_shard_match_reference(sharded):
    """The real ``make_sharded_search`` and ``make_sharded_insert`` on the
    1x1 smoke mesh against the port at S = 1: ids exact, distances 1e-3,
    the shard's state exact after each."""
    eng, teng = sharded["eng"], sharded["teng"]
    one = jax.tree.map(lambda x: x[:1], sharded["sstate"])
    qs = sharded["queries"]
    mesh = make_smoke_mesh()
    fn = jdist.make_sharded_search(eng, mesh, n_per=N_MAX, n_queries=16)
    with mesh:
        ids, dists, one = fn(one, jnp.asarray(qs))
    tids, tdists, tstates = tdist.make_sharded_search(teng, N_MAX)(
        sharded["tstates"][:1], _t(qs))
    _same(tids, ids, "ids")
    _close(tdists, dists, "dists")
    _same_tree(tstates[0], _shard(one, 0), "state after the search")

    vs = sharded["inserts"][:6]
    routed, valid = jdist.route_inserts(jnp.asarray(vs), jnp.arange(6), 1, 8)
    ins = jdist.make_sharded_insert(eng, mesh, bucket=8)
    with mesh:
        one = ins(one, routed, valid)
    tins = tdist.make_sharded_insert(teng, 8)
    before = tstates[0]
    tstates = tins(tstates, _t(routed), _t(valid))
    _same_shard(tstates[0], _shard(one, 0), before, "state after the insert")
    assert tstates[0].store.count == PER + 6
    assert not tins.last_stats[0].dropped.any()


# ---------------------------------------------------------------------------
# S = 4: per-shard reference calls and the restated merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parallel", [True, False])
def test_sharded_search_matches_reference(sharded, parallel):
    """Every shard through ``search_many`` (``search_batch`` when not
    parallel), the merge restated in numpy: global ids exact, distances
    1e-3, every shard's state (cache replay, counters) exact."""
    eng, teng, qs = sharded["eng"], sharded["teng"], sharded["queries"]
    search = eng.search_many if parallel else eng.search_batch
    ids, dists, states = [], [], []
    for s in range(S):
        i, d, _, st = search(_shard(sharded["sstate"], s), jnp.asarray(qs))
        ids.append(i)
        dists.append(d)
        states.append(st)
    want_i, want_d = _merge_np(ids, dists, PER)
    fn = tdist.make_sharded_search(teng, PER, parallel=parallel)
    tids, tdists, tstates = fn(sharded["tstates"], _t(qs))
    _same(tids, want_i, "ids")
    _close(tdists, want_d, "dists")
    for s in range(S):
        _same_tree(tstates[s], states[s], f"shard {s}")
    assert set(fn.last_timing) == {"search_s", "gather_s", "merge_s"}
    truth = brute_force_topk(_t(qs), _t(sharded["vecs"]), N, 10)
    assert recall_at_k(tids, truth) >= 0.75


def _fresh(sharded):
    """FreshDiskANN adopting every navis shard's build, in both packages."""
    eng, sstate = sharded["eng"], sharded["sstate"]
    feng = JEngine(_spec("freshdiskann"))
    states = []
    for s in range(S):
        st = _shard(sstate, s)
        states.append(feng.build(
            jax.random.PRNGKey(2), jnp.asarray(
                sharded["vecs"][s * PER:(s + 1) * PER]),
            shared=(eng.codec, st.codes, st.store)))
    return (feng, states, interop.engine_from(feng, device="cpu"),
            [interop.engine_state_from(st, "cpu") for st in states])


@pytest.mark.parametrize("case", ["navis", "navis_sequential",
                                  "freshdiskann"])
def test_sharded_insert_matches_reference(sharded, case):
    """Ten inserts routed to four buckets of 3 (two shards padded): navis
    through each shard's ``insert_many(valid=)``; navis with
    ``parallel=False`` and FreshDiskANN (buffered) through ``insert`` for
    each kept lane, in lane order.  Every shard's state and per-lane
    OpStats exact."""
    if case == "freshdiskann":
        eng, states, teng, tstates = _fresh(sharded)
    else:
        eng, teng = sharded["eng"], sharded["teng"]
        states = [_shard(sharded["sstate"], s) for s in range(S)]
        tstates = sharded["tstates"]
    parallel = case == "navis"
    vs = sharded["inserts"]
    routed, valid = jdist.route_inserts(jnp.asarray(vs),
                                        jnp.arange(N, N + 10), S, 3)
    fn = tdist.make_sharded_insert(teng, 3, parallel=parallel)
    got = fn(tstates, _t(routed), _t(valid))
    for s in range(S):
        st, ok = states[s], np.asarray(valid[s])
        if parallel:
            stats, st = eng.insert_many(st, routed[s], valid[s])
            _same_tree(fn.last_stats[s], stats, f"shard {s} OpStats")
        else:
            for lane in np.flatnonzero(ok):
                stats, st, _ = eng.insert(st, routed[s][lane])
                _same_tree(jax.tree.map(lambda x: x[lane], fn.last_stats[s]),
                           stats, f"shard {s} lane {lane} OpStats")
        _same_shard(got[s], st, tstates[s], f"shard {s}")
        assert not fn.last_stats[s].dropped.any()
        assert int(fn.last_stats[s].read_requests[~_t(ok)].sum()) == 0
    grown = [g.store.count + g.buf_count - t.store.count - t.buf_count
             for g, t in zip(got, tstates)]
    assert grown == [3, 3, 2, 2]


# ---------------------------------------------------------------------------
# the merge's tie order
# ---------------------------------------------------------------------------

def _jax_merge(all_i, all_d, k):
    """distributed.py:131-137 on gathered [S, Q, k] pools, in JAX."""
    q = all_d.shape[1]
    neg, sel = lax.top_k(-jnp.asarray(all_d).transpose(1, 0, 2).reshape(
        q, -1), k)
    gi = jnp.take_along_axis(jnp.asarray(all_i).transpose(1, 0, 2).reshape(
        q, -1), sel, axis=1)
    return np.asarray(jnp.where(neg > -INF, gi, -1)), np.asarray(-neg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_ties_follow_lax_top_k(seed):
    """Pools full of equal distances and INF padding: the stable merge
    keeps ``lax.top_k``'s order (the lower shard, then the lower slot)."""
    rng = np.random.default_rng(seed)
    s, q, k = 5, 7, 10
    d = rng.integers(0, 4, (s, q, k)).astype(np.float32)
    d = np.sort(d, axis=2)
    d[rng.random((s, q, k)) < 0.3] = INF
    ids = np.where(d < INF, rng.integers(0, 10_000, (s, q, k)), -1)
    got_i, got_d = tdist.merge_topk(_t(ids.astype(np.int32)), _t(d), k)
    want_i, want_d = _jax_merge(ids.astype(np.int32), d, k)
    _same(got_i, want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)


def test_duplicate_across_shards_keeps_the_lower_shard_first(sharded):
    """One vector inserted into shards 1 and 3: a search for it finds both
    copies at distance 0, shard 1's first, as the reference's ``lax.top_k``
    merges the same pools."""
    teng = sharded["teng"]
    x = sharded["inserts"][:1]
    routed = np.zeros((S, 1, D), np.float32)
    routed[[1, 3], 0] = x[0]
    valid = np.zeros((S, 1), bool)
    valid[[1, 3], 0] = True
    states = tdist.make_sharded_insert(teng, 1)(sharded["tstates"],
                                                _t(routed), _t(valid))
    fn = tdist.make_sharded_search(teng, N_MAX)
    ids, dists, _ = fn(states, _t(x))
    assert ids[0, :2].tolist() == [1 * N_MAX + PER, 3 * N_MAX + PER]
    assert dists[0, :2].tolist() == [0.0, 0.0]
    per = [teng.search_many(st, _t(x))[:2] for st in states]
    all_i = np.stack([np.where(i.numpy() >= 0, i.numpy() + s * N_MAX, -1)
                      for s, (i, _) in enumerate(per)]).astype(np.int32)
    all_d = np.stack([np.where(i.numpy() >= 0, d.numpy(), INF)
                      for i, d in per]).astype(np.float32)
    want_i, want_d = _jax_merge(all_i, all_d, teng.spec.k)
    _same(ids, want_i)
    np.testing.assert_array_equal(dists.numpy(), want_d)


# ---------------------------------------------------------------------------
# the global-id collision past n_per
# ---------------------------------------------------------------------------

def test_reference_global_ids_collide_past_n_per(sharded):
    """The reference test globalises with ``n_per = N // S`` while a
    shard's ``n_max`` is ``N // S + 16``: after a routed insert, shard 0's
    local id 128 gets global id 128, which is shard 1's vertex 0 too
    (ROADMAP queue 3).  The port's sharded search refuses such shards."""
    eng, teng = sharded["eng"], sharded["teng"]
    routed, valid = jdist.route_inserts(jnp.asarray(sharded["inserts"]),
                                        jnp.arange(N, N + 10), S, 3)
    _, s0 = eng.insert_many(_shard(sharded["sstate"], 0), routed[0],
                            valid[0])
    mine, _, _, _ = eng.search_many(s0, routed[0][:1])
    other, _, _, _ = eng.search_many(_shard(sharded["sstate"], 1),
                                     jnp.asarray(sharded["vecs"][PER:PER + 1]))
    assert int(mine[0, 0]) == PER and int(other[0, 0]) == 0
    # distributed.py:125 on both: two vectors, one global id
    assert int(mine[0, 0]) + 0 * PER == int(other[0, 0]) + 1 * PER
    tstates = tdist.make_sharded_insert(teng, 3)(
        sharded["tstates"], _t(routed), _t(valid))
    with pytest.raises(ValueError, match="n_per"):
        tdist.make_sharded_search(teng, PER)(tstates, _t(sharded["queries"]))
    ids, _, _ = tdist.make_sharded_search(teng, N_MAX)(
        tstates, _t(sharded["queries"]))
    assert int(ids.max()) < S * N_MAX


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------

def test_two_gloo_ranks_match_one_process(sharded, tmp_path):
    """Two ranks, two shards each, joined through a ``file://`` store: the
    gathered merge's ids and distances and every owned shard's state after
    the search and after the insert equal the ``group=None`` run's,
    exactly."""
    teng, tstates = sharded["teng"], sharded["tstates"]
    qs = _t(sharded["queries"])
    routed, valid = tdist.route_inserts(_t(sharded["inserts"]),
                                        list(range(N, N + 10)), S, 3,
                                        device="cpu")
    ids, dists, searched = tdist.make_sharded_search(teng, N_MAX)(tstates,
                                                                  qs)
    inserted = tdist.make_sharded_insert(teng, 3)(searched, routed, valid)
    job, out = tmp_path / "job.pt", tmp_path / "out"
    torch.save(dict(spec=teng.spec, codebooks=teng.codec.codebooks,
                    states=tstates, queries=qs, routed=routed, valid=valid,
                    n_per=N_MAX, bucket=3), job)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_dist_worker.run,
                         args=(r, 2, str(tmp_path / "store"), str(job),
                               str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in 120 s"
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        g_ids, g_d, g_searched, g_inserted = torch.load(f"{out}.{r}",
                                                        weights_only=False)
        assert torch.equal(g_ids, ids) and torch.equal(g_d, dists)
        for j, s in enumerate(range(2 * r, 2 * r + 2)):
            _same_tree(g_searched[j], searched[s], f"rank {r} shard {s}")
            _same_tree(g_inserted[j], inserted[s], f"rank {r} shard {s}")


# ---------------------------------------------------------------------------
# state_shapes on the meta device
# ---------------------------------------------------------------------------

def _leaves(obj, prefix=""):
    """(path, value) of every field of a port state object."""
    import dataclasses
    for f in dataclasses.fields(obj):
        v, name = getattr(obj, f.name), f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{name}.")
        else:
            yield name, v


def _ref_leaf(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


# page-indexed fields: the port's page budget where the reference has 2n
_PAGED = {"store.page_live", "cache.status", "cache.hits", "cache.slot_of"}


@pytest.mark.parametrize("dim,r,pq_m,n_shards,n_per", [
    (D, 12, 16, 4, PER),         # page budget == 2 * n_per at r 12
    (768, 48, 96, 8, 1000),      # the FineWeb-like widths: it is larger
])
def test_state_shapes_match_reference(dim, r, pq_m, n_shards, n_per):
    """Every field's shape and dtype equal the reference's
    ``ShapeDtypeStruct`` without its shard axis, with the port's listed
    differences: the page-indexed arrays span ``page_budget(n_per, r)``
    pages (the reference's ``2 * n_per``); host counts are Python ints
    (0-d int32 there); counters are int64 and the cache key an int64 pair
    (a uint32 pair there).  Nothing is allocated: every tensor is meta."""
    spec = jpreset("navis", dim=dim, r=r, pq_m=pq_m, n_max=64,
                   buffer_max=32)
    want = jdist.state_shapes(JEngine(spec), n_shards, n_per)
    got = tdist.state_shapes(TEngine(interop.spec_from(spec), "cpu"),
                             n_shards, n_per)
    assert len(got) == n_shards
    budget = page_budget(n_per, r)
    assert (budget == 2 * n_per) == (r == 12)
    for path, v in _leaves(got[0]):
        w = _ref_leaf(want, path)
        assert w.shape[0] == n_shards, path
        if not isinstance(v, torch.Tensor):
            assert isinstance(v, int) and w.shape[1:] == () and \
                w.dtype == jnp.int32, path
            continue
        assert v.is_meta, path
        shape = tuple(w.shape[1:])
        if path in _PAGED:
            assert shape == (2 * n_per,), path
            shape = (budget,)
        assert tuple(v.shape) == shape, path
        if path.startswith("ctr_") or path == "cache.key":
            assert v.dtype == torch.int64, path
            assert w.dtype in (jnp.int32, jnp.int64, jnp.uint32), path
        else:
            assert str(v.dtype).split(".")[1] == str(w.dtype), path


# ---------------------------------------------------------------------------
# the dry-run on a production-like mesh
# ---------------------------------------------------------------------------

_DRYRUN_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    from repro.core import Engine, pq, preset
    from repro.core import distributed as dist
    from repro.launch.dryrun import parse_collectives
    from repro.launch.mesh import make_mesh

    kw, n_per, n_queries, bucket = json.loads(sys.argv[1])
    eng = Engine(preset("navis", **kw))
    key = jax.random.PRNGKey(0)
    eng.codec = pq.train_pq(key, jax.random.normal(key, (256, kw["dim"])),
                            kw["pq_m"])
    eng._sym = pq.sym_tables(eng.codec)
    out = dist.dryrun(eng, make_mesh((2, 2), ("data", "model")),
                      n_per=n_per, n_queries=n_queries, bucket=bucket)
    print(json.dumps({op: parse_collectives(c.as_text())
                      for op, (_, c) in out.items()}))
""")


def test_dryrun_collectives_match_reference():
    """``dryrun`` on 4 devices (2 x 2): the search's pool gathers (ids and
    distances of every shard's [Q, k] pools) equal, by kind in calls and
    bytes, the collectives the reference's compiled search holds
    (``parse_collectives``, in a subprocess with 4 fake devices); the
    insert has none in either.  Its state bytes are ``state_shapes``'s,
    its input bytes the wave's and the routed bucket's."""
    kw = dict(dim=D, r=12, n_max=N_MAX, e_search=32, e_pos=40, pq_m=16,
              cache_capacity_pages=64, max_hops=48, buffer_max=32,
              ent_frac=0.10)
    n_queries, bucket = 16, 4
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _DRYRUN_SCRIPT,
         json.dumps([kw, PER, n_queries, bucket])], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    eng = TEngine(interop.spec_from(jpreset("navis", **kw)), "cpu")
    got = tdist.dryrun(eng, PM.Mesh({"data": 2, "model": 2}, virtual=True),
                       n_per=PER, n_queries=n_queries, bucket=bucket)
    k = eng.spec.k
    assert got["search"]["collectives"] == want["search"]
    assert want["search"]["bytes_by_kind"]["all-gather"] == \
        4 * n_queries * k * (4 + 4)
    assert got["insert"]["collectives"] == want["insert"]
    assert want["insert"]["bytes_by_kind"]["total"] == 0
    state = tdist.state_shapes(eng, 1, PER)[0]
    assert got["search"]["state_bytes"] == got["insert"]["state_bytes"] == \
        sum(v.numel() * v.element_size() for _, v in _leaves(state)
            if isinstance(v, torch.Tensor))
    assert got["search"]["input_bytes"] == n_queries * D * 4
    assert got["insert"]["input_bytes"] == bucket * D * 4 + bucket
    assert got["search"]["devices"] == 4 and got["search"]["left_out"]
