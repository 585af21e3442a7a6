"""The port's core modules against the reference on identical inputs:
visited sets, the cache replay, PQ, the entrance linking, RobustPrune,
and the corrected edge-page budget."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import entrance as jent
from repro.core import graph as jgraph
from repro.core import iomodel as jio
from repro.core import pq as jpq
from repro.core import search as jsearch
from repro.core import visited as jvis
from repro.core.layout import LayoutSpec as JLayoutSpec
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import cache as tcache
from repro_torch.core import entrance as tent
from repro_torch.core import graph as tgraph
from repro_torch.core import iomodel as tio
from repro_torch.core import layout as tlayout
from repro_torch.core import pq as tpq
from repro_torch.core import search as tsearch
from repro_torch.core import visited as tvis
from repro_torch.core.engine import Engine, preset
from _torch_threads import one_torch_thread  # noqa: F401


_jadd = jax.jit(jvis.add)
_jcontains = jax.jit(jvis.contains)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64))


# ---------------------------------------------------------------------------
# visited sets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap,rounds,hi", [
    (256, 60, 3000),     # the traversal's exact bound: never overflows
    (4, 8, 60),          # forced small: 8-slot table saturates
    (16, 20, 400),       # 32-slot table past one probe chunk, saturates
    (64, 50, 90),        # dense key range: long probe runs
    (32, 100, 40),       # many repeats within and across calls
    (2, 30, 10),         # 8-slot table, full early
])
def test_hash_visited_matches_reference(cap, rounds, hi):
    """Same key streams per lane -> identical tables, counts, overflow
    counts and membership answers."""
    rng = np.random.default_rng(cap * 7 + rounds)
    lanes = 3
    keys = rng.integers(-1, hi, (lanes, rounds, 4)).astype(np.int32)
    mask = rng.random((lanes, rounds, 4)) < 0.9
    tv = tvis.make_hash(cap, lanes, device="cpu")
    for t in range(rounds):
        tv = tvis.add(tv, torch.from_numpy(keys[:, t]),
                      torch.from_numpy(mask[:, t]))
    probe = rng.integers(-1, hi, (lanes, 64)).astype(np.int32)
    found = tvis.contains(tv, torch.from_numpy(probe)).numpy()
    for b in range(lanes):
        jv = jvis.make_hash(cap)
        for t in range(rounds):
            jv = _jadd(jv, jnp.asarray(keys[b, t]), jnp.asarray(mask[b, t]))
        _same(jv.keys, tv.keys[b])
        assert int(jv.count) == int(tv.count[b])
        assert int(jv.overflow) == int(tv.overflow[b])
        _same(_jcontains(jv, jnp.asarray(probe[b])), found[b])


@pytest.mark.parametrize("n,rounds", [(50, 20), (400, 60)])
def test_dense_visited_matches_reference(n, rounds):
    """The bitmap: keys out of range (negative or >= n) and masked keys
    are dropped, repeats are idempotent, overflow is always 0."""
    rng = np.random.default_rng(n + rounds)
    lanes = 3
    keys = rng.integers(-3, n + 5, (lanes, rounds, 4)).astype(np.int32)
    mask = rng.random((lanes, rounds, 4)) < 0.8
    tv = tvis.make_dense(n, lanes, device="cpu")
    for t in range(rounds):
        tv = tvis.add(tv, torch.from_numpy(keys[:, t]),
                      torch.from_numpy(mask[:, t]))
    probe = rng.integers(-3, n + 5, (lanes, 64)).astype(np.int32)
    found = tvis.contains(tv, torch.from_numpy(probe)).numpy()
    assert not tvis.overflow(tv).any()
    for b in range(lanes):
        jv = jvis.make_dense(n)
        for t in range(rounds):
            jv = _jadd(jv, jnp.asarray(keys[b, t]), jnp.asarray(mask[b, t]))
        _same(jv.bits, tv.bits[b])
        _same(_jcontains(jv, jnp.asarray(probe[b])), found[b])


# ---------------------------------------------------------------------------
# cache replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["navis", "lru", "clock", "lfu", "none"])
def test_apply_traces_matches_reference(policy):
    """Identical traces (re-hit pages, so the NAVIS window promotes into
    the frozen region and draws threefry probes) -> every CacheState
    field identical, the key included."""
    rng = np.random.default_rng(3)
    p_max, cap = 400, 30
    traces = np.full((6, 50), -1, np.int32)
    for q in range(6):
        n = rng.integers(20, 50)
        traces[q, :n] = rng.integers(0, 60, n)
    st_j = jcache.init_cache(p_max, cap, policy, jax.random.PRNGKey(5))
    hits_j, st_j = jcache.apply_traces(st_j, jnp.asarray(traces))
    st_t = tcache.init_cache(p_max, cap, policy, jr.PRNGKey(5),
                             device="cpu")
    hits_t, st_t = tcache.apply_traces(st_t, torch.from_numpy(traces))
    assert int(hits_j) == hits_t
    got, want = interop.to_numpy(st_t), interop.to_numpy(st_j)
    assert set(got) == set(want)
    for name in want:
        _same(got[name], want[name])
    if policy == "navis":
        assert int(st_j.frozen_fill) > 0       # promotions happened


def test_invalidate_pages_matches_reference():
    rng = np.random.default_rng(4)
    traces = rng.integers(0, 40, (4, 40)).astype(np.int32)
    st_j = jcache.init_cache(200, 20, "navis", jax.random.PRNGKey(1))
    _, st_j = jcache.apply_traces(st_j, jnp.asarray(traces))
    st_t = interop.cache_from(st_j, device="cpu")
    for p in (3, 7, 11, 199):
        st_j = jcache.invalidate_page(st_j, jnp.int32(p))
    st_t = tcache.invalidate_pages(st_t, [3, 7, 11, 199])
    got, want = interop.to_numpy(st_t), interop.to_numpy(st_j)
    for name in want:
        _same(got[name], want[name])


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pq_case():
    rng = np.random.default_rng(11)
    cents = rng.standard_normal((8, 48)).astype(np.float32) * 3
    x = (cents[rng.integers(0, 8, 900)] +
         rng.standard_normal((900, 48))).astype(np.float32)
    codec = jpq.train_pq(jax.random.PRNGKey(3), jnp.asarray(x), 24)
    return x, codec


def test_train_pq_matches_reference(pq_case):
    """Same sample draw (threefry) and Lloyd steps: codebooks agree to
    1e-4 (the products sum in another order than XLA's)."""
    x, codec = pq_case
    got = tpq.train_pq(jr.PRNGKey(3), torch.from_numpy(x), 24)
    np.testing.assert_allclose(got.codebooks.numpy(), codec.codebooks,
                               rtol=0, atol=1e-4)


def test_encode_lut_sym_tables_match_reference(pq_case):
    """Codes exact; the ADC LUT and symmetric tables to float32 rounding
    (rtol 1e-5 / atol 1e-4)."""
    x, codec = pq_case
    tc = interop.codec_from(codec, device="cpu")
    _same(jpq.encode(codec, jnp.asarray(x)),
          tpq.encode(tc, torch.from_numpy(x), chunk=256))
    q = x[:5]
    np.testing.assert_allclose(
        tpq.adc_lut(tc, torch.from_numpy(q)).numpy(),
        np.stack([np.asarray(jpq.adc_lut(codec, jnp.asarray(v)))
                  for v in q]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpq.sym_tables(tc).numpy(),
                               jpq.sym_tables(codec), rtol=1e-5, atol=1e-4)


def test_link_members_matches_reference(pq_case):
    """Same members and tables -> identical entrance graph (symmetric
    distances sum the subspaces in order, as XLA does at M = 24)."""
    x, codec = pq_case
    codes = jpq.encode(codec, jnp.asarray(x))
    tables = jpq.sym_tables(codec)
    members = np.random.default_rng(2).permutation(900)[:40].astype(np.int32)
    want = jent.link_members(jnp.asarray(members), codes, tables, c_max=64,
                             r_ent=32, n_max=900)
    got = tent.link_members(torch.from_numpy(members),
                            torch.from_numpy(np.array(codes)),
                            torch.from_numpy(np.array(tables)), c_max=64,
                            r_ent=32, n_max=900)
    w, g = interop.to_numpy(want), interop.to_numpy(got)
    for name in w:
        _same(g[name], w[name])


# ---------------------------------------------------------------------------
# RobustPrune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,r", [(1.0, 16), (1.2, 16), (1.2, 48)])
def test_robust_prune_matches_reference(alpha, r):
    rng = np.random.default_rng(int(alpha * 10) + r)
    vecs = rng.standard_normal((500, 48)).astype(np.float32)
    lanes, c = 4, 64
    q = rng.standard_normal((lanes, 48)).astype(np.float32)
    cand = rng.choice(500, (lanes, c)).astype(np.int32)
    cand[:, -5:] = -1
    d = np.where(cand >= 0, ((vecs[np.maximum(cand, 0)] - q[:, None]) ** 2
                             ).sum(-1), 3.4e38).astype(np.float32)
    got = tgraph.robust_prune(torch.from_numpy(q), torch.from_numpy(cand),
                              torch.from_numpy(d), torch.from_numpy(vecs),
                              alpha=alpha, r=r).numpy()
    for b in range(lanes):
        want = jgraph.robust_prune(jnp.asarray(q[b]), jnp.asarray(cand[b]),
                                   jnp.asarray(d[b]), jnp.asarray(vecs),
                                   alpha=alpha, r=r)
        _same(want, got[b])


# ---------------------------------------------------------------------------
# layout: the page budget
# ---------------------------------------------------------------------------

def test_page_budget_formula():
    """r = 16 keeps the reference's 2 * n_max (so states interoperate);
    r = 48 needs the initial pages plus 3 fresh pages per insert."""
    assert tlayout.page_budget(1600, 16) == 2 * 1600
    per = JLayoutSpec("decoupled", 768, 48).edgelists_per_page
    assert per == 20
    assert tlayout.page_budget(300, 48) == 15 + 300 * 3 > 600


def test_relocate_past_budget_raises():
    spec = tlayout.LayoutSpec("decoupled", 8, 48)
    store = tlayout.assign_initial_pages(
        tlayout.empty_store(10, 8, 48, device="cpu"), spec)
    store = dataclasses.replace(store, next_page=store.p_max - 2)
    ids = torch.arange(49, dtype=torch.int32) % 10
    with pytest.raises(RuntimeError, match="page budget"):
        tlayout.relocate_edgelists(store, ids, ids >= 0, spec)


def test_relocate_moves_vertex_zero():
    """Masked slots must not overwrite a valid vertex 0's new pointer (the
    reference's masked slots write vertex 0's old page over it)."""
    spec = tlayout.LayoutSpec("decoupled", 8, 16)
    store = tlayout.assign_initial_pages(
        tlayout.empty_store(100, 8, 16, device="cpu"), spec)
    fresh = store.next_page
    ids = torch.tensor([5, 0, -1, -1], dtype=torch.int32)
    store, written = tlayout.relocate_edgelists(store, ids, ids >= 0, spec)
    assert int(store.edge_page[0]) == int(store.edge_page[5]) == fresh
    assert int(store.page_live[fresh]) == 2 and int(written) == 1
    counts = torch.bincount(store.edge_page.long(), minlength=store.p_max)
    assert torch.equal(counts.to(torch.int32), store.page_live)


def test_build_at_r48_stays_inside_page_budget():
    """dim 96, r 48, n = n_max = 300: the reference runs past its
    2 * n_max pages here; the port's pages stay in range and page_live
    counts exactly the edgelists that point at each page."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((300, 96), generator=gen) + \
        3 * torch.randn((6, 96), generator=gen)[torch.randint(
            0, 6, (300,), generator=gen)]
    spec = preset("navis", dim=96, r=48, n_max=300, pq_m=24, e_pos=48,
                  max_hops=64, cache_capacity_pages=64, buffer_max=8)
    state = Engine(spec, device="cpu").build(jr.PRNGKey(1), x,
                                             build_block=64, build_e_pos=32)
    store = state.store
    ep = store.edge_page.long()
    assert store.p_max == tlayout.page_budget(300, 48)
    assert store.next_page > 2 * 300          # past the reference's space
    assert store.next_page <= store.p_max
    assert int(ep.max()) < store.p_max and bool((ep >= 0).all())
    counts = torch.bincount(ep, minlength=store.p_max).to(torch.int32)
    assert torch.equal(counts, store.page_live)
    assert int(store.page_live.sum()) == 300
    assert all(tgraph.check_invariants(store).values())


def test_counters_merge_and_sum():
    a = tio.IOCounters.zeros((3,), device="cpu")
    a.hops += torch.tensor([1, 2, 3])
    total = tio.sum_counters(a)
    assert int(total.hops) == 6
    both = tio.merge_counters(total, total)
    assert both.asdict()["hops"] == 12
    names = [f.name for f in dataclasses.fields(jio.IOCounters)]
    assert names == [f.name for f in dataclasses.fields(tio.IOCounters)]


def test_wire_block_equals_serial_structural_updates():
    """Committing a block in conflict-free rounds gives the store that one
    structural_update per vertex, in order, gives — bit for bit."""
    from repro_torch.core import insert as tinsert
    gen = torch.Generator().manual_seed(3)
    r, m, dim, n_max = 8, 4, 8, 200
    codec = tpq.PQCodec(torch.randn((m, 256, dim // m), generator=gen))
    tables = tpq.sym_tables(codec)
    vecs = torch.randn((n_max, dim), generator=gen)
    codes = tpq.encode(codec, vecs)
    for kind in ("decoupled", "packed"):
        spec = tlayout.LayoutSpec(kind, dim, r)
        base = tgraph.bootstrap_store(vecs, spec, n_max, r + 1)
        # neighbors drawn from a few hubs, so commits conflict
        nbrs = torch.randint(0, 30, (60, r), generator=gen).to(torch.int32)
        nbrs[nbrs % 7 == 0] = -1
        block = vecs[r + 1:r + 61]
        serial = dataclasses.replace(
            base, **{f: getattr(base, f).clone() for f in (
                "edges", "degree", "vectors", "edge_page", "page_live")})
        for i in range(60):
            serial = tinsert.structural_update(
                serial, spec, None, None, block[i], nbrs[i], codes,
                tables).store
        batched = tinsert.wire_block(base, spec, block, nbrs, codes, tables)
        rounds = tinsert.commit_rounds(list(range(r + 1, r + 61)),
                                       nbrs.tolist())
        assert 1 < max(rounds) + 1 < 60
        for name in ("edges", "degree", "vectors", "edge_page",
                     "page_live"):
            assert torch.equal(getattr(serial, name),
                               getattr(batched, name)), (kind, name)
        assert (serial.count, serial.next_page) == \
            (batched.count, batched.next_page)


@pytest.mark.parametrize("make", [
    lambda: tlayout.empty_store(10, 8, 16),
    lambda: tcache.init_cache(40, 8, "navis", jr.PRNGKey(0)),
    lambda: tent.empty_entrance(4, 2, 10),
    lambda: tvis.make_hash(8, 2),
    lambda: tio.IOCounters.zeros((2,)),
    lambda: interop.counters_from(jio.IOCounters.zeros()),
], ids=["empty_store", "init_cache", "empty_entrance", "make_hash",
        "IOCounters.zeros", "counters_from"])
def test_state_constructors_default_to_cuda(make):
    """With no device given, state is made on cuda, and without a card the
    call raises instead of carrying on on the host."""
    if torch.cuda.is_available():
        leaves = [v for v in vars(make()).values()
                  if isinstance(v, torch.Tensor)]
        assert leaves and all(t.device.type == "cuda" for t in leaves)
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()


# ---------------------------------------------------------------------------
# small helpers: ADC of one query, decoding, footprints, diagnostics
# ---------------------------------------------------------------------------

def test_adc_distance_and_decode_codes_match_reference(pq_case):
    """One query's ADC over a set of codes (1e-4, the ADC grade) and the
    decoded vectors (exact: a gather of centroids)."""
    x, codec = pq_case
    tc = interop.codec_from(codec, device="cpu")
    codes = jpq.encode(codec, jnp.asarray(x[:300]))
    tcodes = torch.from_numpy(np.array(codes))
    for q in x[-3:]:
        lut = jpq.adc_lut(codec, jnp.asarray(q))
        got = tpq.adc_distance(torch.from_numpy(np.array(lut)), tcodes)
        np.testing.assert_allclose(got.numpy(), jpq.adc_distance(lut, codes),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tpq.decode_codes(tc, tcodes).numpy(),
                                  jpq.decode_codes(codec, codes))


@pytest.mark.parametrize("visited", ["hash", "bitmap"])
@pytest.mark.parametrize("frozen", [False, True])
def test_traversal_state_bytes_matches_reference(visited, frozen):
    """The per-lane traversal footprint, and each visited set's ``nbytes``,
    equal the reference's; in frozen mode the port's trace carries one
    more int32 column (the sink for uncharged slots)."""
    kw = dict(n_max=5000, p_max=9000, pool_size=40, beam_width=4,
              max_hops=96, visited=visited, frozen=frozen)
    want = jsearch.traversal_state_bytes(**kw)
    assert tsearch.traversal_state_bytes(**kw) == want + 4 * frozen
    for jset, tset in ((jvis.make_hash(384), tvis.make_hash(384, 3, "cpu")),
                       (jvis.make_dense(700), tvis.make_dense(700, 3, "cpu"))):
        assert tvis.nbytes(tset) == jvis.nbytes(jset)


def test_entrance_hop_stats_matches_reference(pq_case):
    """The member count and the mean degree of a linked entrance graph,
    with two members dropped."""
    x, codec = pq_case
    codes = jpq.encode(codec, jnp.asarray(x))
    tables = jpq.sym_tables(codec)
    members = np.random.default_rng(5).permutation(900)[:50].astype(np.int32)
    want = jent.link_members(jnp.asarray(members), codes, tables, c_max=64,
                             r_ent=32, n_max=900)
    want = dataclasses.replace(want,
                               ids=want.ids.at[jnp.array([3, 7])].set(-1))
    got = interop.entrance_from(want, device="cpu")
    w, g = jent.entrance_hop_stats(want), tent.entrance_hop_stats(got)
    assert g["count"] == int(w["count"])
    assert g["mean_degree"] == pytest.approx(float(w["mean_degree"]),
                                             rel=1e-6)


@pytest.mark.parametrize("kind,dim,r", [("packed", 48, 16),
                                        ("decoupled", 768, 48),
                                        ("packed", 1536, 96)])
def test_read_pad_bytes_matches_reference(kind, dim, r):
    """The padding of a read of whole pages around its payload."""
    want, got = JLayoutSpec(kind, dim, r), tlayout.LayoutSpec(kind, dim, r)
    for pages, payload in ((1, want.edgelist_bytes),
                           (want.vector_pages_per_read, want.vector_bytes),
                           (want.packed_pages_per_vertex,
                            want.packed_record_bytes)):
        assert got.read_pad_bytes(pages, payload) == \
            want.read_pad_bytes(pages, payload)
