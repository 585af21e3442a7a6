"""The port's kernel layer against the reference's: each plain version
(what the port runs on CPU tensors, and what the CUDA kernels are held to
on the card) against ``repro.kernels.ref`` and the Pallas kernel in
interpret mode, at the main path's shapes; the dispatch contract; and the
import guard that keeps JAX out of the port."""
import ast
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casr as jcasr
from repro.core.iomodel import IOCounters as JCounters
from repro.core.layout import LayoutSpec as JLayoutSpec
from repro.kernels import ref as jref
from repro.kernels.pq_adc import adc_distance_pallas
from repro.kernels.rerank_l2 import rerank_l2_pallas
from repro.kernels.topk_pool import pool_merge_pallas
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import cache as tcache
from repro_torch.core import casr as tcasr
from repro_torch.core import search as tsearch
from repro_torch.core.entrance import EntranceGraph
from repro_torch.core.iomodel import IOCounters
from repro_torch.core.layout import LayoutSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
LANES = 3
INF = np.float32(3.4e38)


def _merge_inputs(rng, p, q):
    """Pools ascending with a padded tail; distances on a 0.25 grid so
    ties occur."""
    pool_d = np.sort(np.round(rng.random((LANES, p)) * 80) / 4, axis=1)
    pool_d = pool_d.astype(np.float32)
    pool_i = rng.integers(0, 5000, (LANES, p)).astype(np.int32)
    pool_d[:, p - p // 4:], pool_i[:, p - p // 4:] = INF, -1
    new_d = (np.round(rng.random((LANES, q)) * 80) / 4).astype(np.float32)
    new_i = rng.integers(0, 5000, (LANES, q)).astype(np.int32)
    drop = rng.random((LANES, q)) < 0.2
    new_d[drop], new_i[drop] = INF, -1
    return pool_d, pool_i, new_d, new_i


@pytest.mark.parametrize("p,q", [(40, 192), (32, 32), (10, 30), (64, 128)])
def test_pool_merge_plain_matches_reference(p, q):
    """Exact on distances and ids: a stable merge, ties by position."""
    rng = np.random.default_rng(p * 1000 + q)
    args = _merge_inputs(rng, p, q)
    got_d, got_i = ops.pool_merge(*map(torch.from_numpy, args))
    for b in range(LANES):
        lane = [jnp.asarray(a[b]) for a in args]
        for want_d, want_i in (jref.pool_merge_ref(*lane),
                               pool_merge_pallas(*lane, interpret=True)):
            np.testing.assert_array_equal(got_d[b].numpy(), want_d)
            np.testing.assert_array_equal(got_i[b].numpy(), want_i)


def _adversarial_merge(case):
    """One lane's (pool_d, pool_ids, new_d, new_ids) for a case the merge
    must get right whatever order or values its inputs arrive in."""
    rng = np.random.default_rng(len(case))
    p, q = {"all_equal": (40, 192), "unsorted_pool": (40, 192),
            "signed_zero": (40, 192), "p_greater_than_q": (64, 8),
            "at_limit": (512, 512)}[case]
    d = (np.round(rng.random(p + q) * 40) / 4).astype(np.float32)
    if case == "all_equal":
        d[:] = 1.5
    elif case == "signed_zero":
        d[rng.random(p + q) < 0.5] = 0.0
        d[rng.random(p + q) < 0.5] = -0.0
    elif case != "unsorted_pool":
        d[:p] = np.sort(d[:p])
    d[p + q // 2:][rng.random(q - q // 2) < 0.3] = INF
    ids = rng.permutation(10 ** 5)[:p + q].astype(np.int32)
    return d[:p], ids[:p], d[p:], ids[p:]


@pytest.mark.parametrize("case", ["all_equal", "unsorted_pool",
                                  "signed_zero", "p_greater_than_q",
                                  "at_limit"])
def test_pool_merge_plain_adversarial(case):
    """Exact against the reference and the Pallas kernel in interpret mode,
    the distances bit for bit (so -0.0 stays -0.0): every distance equal,
    an unsorted pool, -0.0 beside 0.0, P > Q, and P + Q at the kernel's
    limit of 1024."""
    args = _adversarial_merge(case)
    got_d, got_i = ops.pool_merge(*[torch.from_numpy(a)[None]
                                    for a in args])
    lane = [jnp.asarray(a) for a in args]
    for want_d, want_i in (jref.pool_merge_ref(*lane),
                           pool_merge_pallas(*lane, interpret=True)):
        np.testing.assert_array_equal(got_d[0].numpy().view(np.int32),
                                      np.asarray(want_d).view(np.int32))
        np.testing.assert_array_equal(got_i[0].numpy(), want_i)


def _order_keys(d, pos):
    """order_key.cuh on the host: the order-preserving bits of d (-0.0 as
    +0.0) over the position, as uint64."""
    u = np.asarray(d, np.float32).view(np.uint32).copy()
    u[(u & 0x7FFFFFFF) == 0] = 0
    u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    return (u << np.uint64(32)) | np.asarray(pos, np.uint64)


def _bitonic(keys):
    """The kernel's sort network on the host: bitonic over 2^n >= 32
    elements padded with all-ones keys (the kernel's threads, one key
    each), element e compared with e ^ j at stage (k, j), ascending where
    e & k == 0."""
    n = max(32, 1 << max(len(keys) - 1, 0).bit_length())
    v = np.full(n, np.uint64(2 ** 64 - 1))
    v[:len(keys)] = keys
    e = np.arange(n)
    k = 2
    while k <= n:
        j = k // 2
        while j:
            lo = e[(e & j) == 0]
            a, b = v[lo], v[lo | j]
            up = (lo & k) == 0
            swap = np.where(up, a > b, a < b)
            v[lo] = np.where(swap, b, a)
            v[lo | j] = np.where(swap, a, b)
            j //= 2
        k *= 2
    return v


def _merge_mirror(pool_d, pool_i, new_d, new_i):
    """csrc/pool_merge.cu on the host for one lane.  The route: the pool is
    sorted when each of its keys lies below the next.  Sorted: the n new
    keys below the pool's largest survive; unless n (n + P) > 3 N
    log2(N)^2 (N, the threads: the power of two >= L, at least 32), a
    survivor's place is the survivors below it (counted) and the pool
    keys below it (a binary search), a pool key's its index and the
    survivors below it.  Otherwise: all L keys through the bitonic
    network, the first P kept.  Returns (d, ids, route index into
    ops.POOL_MERGE_ROUTES)."""
    p = len(pool_d)
    d = np.concatenate([pool_d, new_d]).astype(np.float32)
    ids = np.concatenate([pool_i, new_i])
    keys = _order_keys(d, np.arange(len(d)))
    pk = keys[:p]
    n_threads = max(32, 1 << (len(d) - 1).bit_length())
    lg = n_threads.bit_length() - 1
    cand = keys[p:]
    survivors = cand[cand < pk[-1]]
    n = len(survivors)
    is_sorted = bool(np.all(pk[:-1] < pk[1:]))
    if not is_sorted or n * (n + p) > 3 * n_threads * lg * lg:
        out = _bitonic(keys)[:p]
        pos = (out & np.uint64(0xFFFFFFFF)).astype(np.int64)
        return d[pos], ids[pos], 1 if is_sorted else 2
    out = np.zeros(p, np.uint64)
    filled = np.zeros(p, np.int64)
    for key in survivors:
        r = (survivors < key).sum() + np.searchsorted(pk, key)
        if r < p:
            out[r], filled[r] = key, filled[r] + 1
    for i, key in enumerate(pk):
        r = i + (survivors < key).sum()
        if r < p:
            out[r], filled[r] = key, filled[r] + 1
    assert (filled == 1).all(), "a slot not written exactly once"
    pos = (out & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return d[pos], ids[pos], 0


def _route_case(case):
    """One lane's (pool_d, pool_ids, new_d, new_ids) for the mirror: ties
    on the 0.25 grid (few survivors, or an INF-padded pool that lets most
    in), -0.0 beside 0.0, 3.4e38 ties between different ids, unsorted
    pools (short, long, and a wide P), a pool sorted but for its last
    pair, P > Q, L = 1,024 (sorted and not), and FreshDiskANN's chunks of
    (10, 1,014) with a converged and an INF-padded pool."""
    rng = np.random.default_rng(sum(map(ord, case)))
    p, q = {"grid_few": (40, 192), "grid_many": (40, 192),
            "grid_64_192": (64, 192), "signed_zero": (40, 192),
            "inf_ties": (40, 192), "unsorted_short": (10, 30),
            "unsorted_long": (40, 192), "unsorted_wide": (100, 300),
            "last_pair_swapped": (40, 192),
            "p_greater_than_q": (64, 8), "l1024_sorted": (512, 512),
            "l1024_unsorted": (24, 1000), "chunk_few": (10, 1014),
            "chunk_many": (10, 1014)}[case]
    grid = lambda m: (np.round(rng.random(m) * 80) / 4).astype(np.float32)
    ids = rng.permutation(10 ** 5)[:p + q].astype(np.int32)
    new_d = grid(q)
    if case in ("grid_few", "grid_64_192", "chunk_few", "p_greater_than_q"):
        pool_d = np.sort(grid(8 * (p + q)))[:p]
    elif case == "signed_zero":
        pool_d = np.sort(grid(p)) * (rng.random(p) < 0.5)
        pool_d[rng.random(p) < 0.5] *= -1
        new_d[rng.random(q) < 0.3] = 0.0
        new_d[rng.random(q) < 0.3] = -0.0
        pool_d = pool_d[np.argsort(pool_d, kind="stable")]
    elif case == "inf_ties":
        pool_d = np.sort(grid(p))
        pool_d[p - p // 4:] = INF
        new_d[rng.random(q) < 0.6] = INF
    elif case in ("unsorted_short", "unsorted_long", "unsorted_wide",
                  "l1024_unsorted"):
        pool_d = grid(p)
    else:
        pool_d = np.sort(grid(p))
        pool_d[p - p // 4:] = INF
        ids[p - p // 4:p] = -1
        if case == "last_pair_swapped":
            pool_d = np.sort(grid(p))
            pool_d[-2], pool_d[-1] = pool_d[-1] + 1, pool_d[-2]
    return pool_d.astype(np.float32), ids[:p], new_d, ids[p:]


ROUTE_CASES = ("grid_few", "grid_many", "grid_64_192", "signed_zero",
               "inf_ties", "unsorted_short", "unsorted_long",
               "unsorted_wide", "last_pair_swapped", "p_greater_than_q",
               "l1024_sorted", "l1024_unsorted", "chunk_few", "chunk_many")


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_pool_merge_route_mirror(case):
    """The CUDA merge's route choice and its two routes (survivors ranked
    by counting and placed by co-rank; the bitonic network), mirrored on
    the host, bit for bit against the reference's merge and the Pallas
    kernel in interpret mode (distance bits, so -0.0 stays -0.0, and ids)
    and against the port's plain version; the unsorted route is taken
    exactly where the pool's distances are not ascending (-0.0 equal to
    0.0), as the card's route counts are held to in ``chip_smoke.py``."""
    args = _route_case(case)
    got_d, got_i, route = _merge_mirror(*args)
    lane = [jnp.asarray(a) for a in args]
    for want_d, want_i in (jref.pool_merge_ref(*lane),
                           pool_merge_pallas(*lane, interpret=True)):
        np.testing.assert_array_equal(got_d.view(np.int32),
                                      np.asarray(want_d).view(np.int32))
        np.testing.assert_array_equal(got_i, want_i)
    t = [torch.from_numpy(a)[None] for a in args]
    plain_d, plain_i = ops.pool_merge(*t)
    np.testing.assert_array_equal(plain_d[0].numpy().view(np.int32),
                                  got_d.view(np.int32))
    np.testing.assert_array_equal(plain_i[0].numpy(), got_i)
    assert (route == 2) == bool(np.any(args[0][:-1] > args[0][1:]))


def test_pool_merge_route_cases_cover_every_route():
    """The mirror's cases reach all three routes: FreshDiskANN's chunk and
    the hop's (40, 192) with converged pools count, the chunk with an
    INF-padded pool (~800 survivors) takes the network, and a pool sorted
    but for its last pair the unsorted route."""
    routes = {case: _merge_mirror(*_route_case(case))[2]
              for case in ROUTE_CASES}
    assert set(routes.values()) == {0, 1, 2}
    assert routes["chunk_few"] == routes["grid_few"] == 0
    assert routes["chunk_many"] == 1
    assert routes["last_pair_swapped"] == 2


def _casr_inputs(p: int, lanes: int = 6, n: int = 300, d: int = 48):
    """A store with duplicated rows (exact ties that only the pool position
    can break), queries near stored rows, pools in a noisy distance order
    (a PQ order's stand-in) with -1 tails of random length, and one lane
    whose pool is all -1."""
    rng = np.random.default_rng(p)
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    vectors[n // 2:n // 2 + 40] = vectors[:40]
    qs = (vectors[rng.integers(0, 40, lanes)] +
          0.7 * rng.standard_normal((lanes, d))).astype(np.float32)
    pools = np.full((lanes, p), -1, np.int32)
    for b in range(lanes - 1):
        ids = rng.permutation(n)[:p]
        ids[:6] = np.r_[np.arange(3) + 5 * b, np.arange(3) + 5 * b + n // 2]
        dist = ((vectors[ids] - qs[b]) ** 2).sum(1)
        order = np.argsort(dist + rng.normal(0, 8, p), kind="stable")
        tail = rng.integers(0, p // 2)
        pools[b, :p - tail] = ids[order][:p - tail]
    return vectors, qs, pools


@pytest.mark.parametrize("s,p", [(4, 40), (8, 40), (4, 64), (8, 64),
                                 (1, 40), (8, 256)])
def test_casr_rerank_plain_matches_reference(p, s):
    """The plain CASR loop (what the fused kernel is held to on the card)
    and the port's CASR stage against the reference's casr_rerank_many,
    lane by lane: ids, loaded flags, loads, groups, rounds and I/O
    counters exact; distances to 1e-3 abs (the repo's rerank gate: the
    sums run in another order).  s 1 at P 40 is the longest chain of
    rounds, P 256 / s 8 the kernel's limit."""
    k = 10
    vectors, qs, pools = _casr_inputs(p)
    want = jcasr.casr_rerank_many(
        types.SimpleNamespace(vectors=jnp.asarray(vectors)),
        JLayoutSpec(kind="decoupled", dim=vectors.shape[1], r=16),
        jnp.asarray(qs), jnp.asarray(pools), JCounters.zeros(), k=k, s=s)
    tq, tpools = torch.from_numpy(qs), torch.from_numpy(pools)
    exact_d, loaded, topk_ids, topk_d, n_loaded, rounds = \
        ref.casr_rerank_ref(tq, torch.from_numpy(vectors), tpools, k, s)
    got = tcasr.casr_rerank(
        types.SimpleNamespace(vectors=torch.from_numpy(vectors)),
        LayoutSpec(kind="decoupled", dim=vectors.shape[1], r=16), tq,
        tpools, IOCounters.zeros((len(qs),), device="cpu"), k=k, s=s)
    assert bool((want.n_groups[:-1] >= 2).any()), "no lane ran a 2nd group"
    assert int(want.n_groups[-1]) == -(-p // s), "all -1 lane stopped early"
    for name, value in (("topk_ids", topk_ids), ("loaded", loaded),
                        ("n_loaded", n_loaded),
                        ("n_groups", rounds - 1)):
        np.testing.assert_array_equal(
            value.numpy().astype(np.int64),
            np.asarray(getattr(want, name)).astype(np.int64), name)
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      value.numpy(), name)
    for name, value in (("exact_d", exact_d), ("topk_d", topk_d)):
        np.testing.assert_allclose(value.numpy(), getattr(want, name),
                                   rtol=0, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(got.rerank_rounds.numpy(),
                                  want.rerank_rounds)
    g_ctr, w_ctr = (interop.to_numpy(c) for c in (got.counters,
                                                  want.counters))
    for field in w_ctr:
        np.testing.assert_array_equal(g_ctr[field], w_ctr[field], field)


@pytest.mark.parametrize("m", [24, 32, 96])
def test_adc_plain_matches_reference(m):
    """1e-4 abs, the reference's own ADC gate on its inputs (a uniform
    [0, 1) LUT, benchmarks/kernel_parity.py): XLA may sum the subspaces in
    another order than the port's in-order loop."""
    rng = np.random.default_rng(m)
    lut = rng.random((LANES, m, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (LANES, 40, m)).astype(np.uint8)
    got = ops.adc_distance(torch.from_numpy(lut), torch.from_numpy(codes))
    for b in range(LANES):
        l, c = jnp.asarray(lut[b]), jnp.asarray(codes[b])
        for want in (jref.adc_distance_ref(l, c),
                     adc_distance_pallas(l, c, block_b=32, interpret=True)):
            np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                       atol=1e-4)


def test_adc_plain_sums_in_order():
    """The plain version accumulates m = 0, 1, ... in float32, which is
    what the CUDA kernel does: bit-exact with an explicit numpy loop."""
    rng = np.random.default_rng(5)
    lut = (rng.random((2, 96, 256)) * 10).astype(np.float32)
    codes = rng.integers(0, 256, (2, 50, 96)).astype(np.uint8)
    got = ref.adc_distance_ref(torch.from_numpy(lut),
                               torch.from_numpy(codes)).numpy()
    want = np.zeros((2, 50), np.float32)
    for m in range(96):
        want = want + np.take_along_axis(lut[:, m], codes[:, :, m].astype(
            np.int64), axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [48, 768])
def test_rerank_plain_matches_reference(d):
    """rtol 1e-5 / atol 1e-3, the repo's D=768 rerank gate: the sums run
    in another order, and the Pallas kernel uses the expanded form."""
    rng = np.random.default_rng(d)
    cent = rng.standard_normal((LANES, d)).astype(np.float32) * 3
    q = cent + rng.standard_normal((LANES, d)).astype(np.float32)
    xs = cent[:, None] + rng.standard_normal((LANES, 4, d)).astype(
        np.float32)
    got = ops.rerank_l2(torch.from_numpy(q), torch.from_numpy(xs))
    for b in range(LANES):
        qb, xb = jnp.asarray(q[b]), jnp.asarray(xs[b])
        for want in (jref.rerank_l2_ref(qb, xb),
                     rerank_l2_pallas(qb, xb, group=4, interpret=True)):
            np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-5,
                                       atol=1e-3)


@pytest.mark.parametrize("d", [48, 768])
def test_rerank_rows_plain_matches_gathered(d):
    """The by-id entry's plain version: each row's value is the gathered
    rerank's (bit for bit) and within the rerank grade of the reference's;
    -1 ids give INF."""
    rng = np.random.default_rng(d + 1)
    vectors = rng.standard_normal((300, d)).astype(np.float32)
    ids = rng.integers(0, 300, (LANES, 37)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0, 3] = ids[0, 4]                                    # a repeat
    q = vectors[ids[:, 0].clip(0)] + rng.standard_normal(
        (LANES, d)).astype(np.float32)
    tq, tv, ti = map(torch.from_numpy, (q, vectors, ids))
    got = ops.rerank_l2_rows(tq, tv, ti).numpy()
    gathered = ops.rerank_l2(tq, tv[ti.clamp(min=0).long()]).numpy()
    ok = ids >= 0
    np.testing.assert_array_equal(got[ok], gathered[ok])
    assert (got[~ok] == INF).all()
    for b in range(LANES):
        want = jref.rerank_l2_ref(jnp.asarray(q[b]),
                                  jnp.asarray(vectors[ids[b].clip(0)]))
        np.testing.assert_allclose(got[b][ok[b]], np.asarray(want)[ok[b]],
                                   rtol=1e-5, atol=1e-3)


def _shared_inputs(d: int, s: int = 37):
    """Lanes near rows of one shared block, one lane on a row itself."""
    rng = np.random.default_rng(d + 2)
    cent = rng.standard_normal((4, d)).astype(np.float32) * 3
    rows = (cent[rng.integers(0, 4, s)] +
            rng.standard_normal((s, d)).astype(np.float32))
    q = rows[rng.integers(0, s, LANES)] + rng.standard_normal(
        (LANES, d)).astype(np.float32)
    q[0] = rows[1]
    return q, rows


@pytest.mark.parametrize("d", [48, 768])
def test_rerank_shared_plain_matches_reference(d):
    """Every lane against the same rows: within the rerank grade of the
    reference's rerank vmapped over the lanes with the rows shared, and of
    the Pallas kernel (interpret mode, expanded form) lane by lane."""
    q, rows = _shared_inputs(d)
    got = ops.rerank_l2_shared(torch.from_numpy(q), torch.from_numpy(rows),
                               rows.shape[0]).numpy()
    vmapped = jax.vmap(jref.rerank_l2_ref, in_axes=(0, None))(
        jnp.asarray(q), jnp.asarray(rows))
    np.testing.assert_allclose(got, vmapped, rtol=1e-5, atol=1e-3)
    for b in range(LANES):
        want = rerank_l2_pallas(jnp.asarray(q[b]), jnp.asarray(rows),
                                group=8, interpret=True)
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("d", [48, 768])
@pytest.mark.parametrize("count", [0, 1, 20, 37])
def test_rerank_shared_plain_equals_rows_on_slot_ids(d, count):
    """Bit for bit what the by-id entry gives on the slots' ids (-1 from
    ``count`` on), which the buffer scan ran before: INF past ``count``."""
    q, rows = _shared_inputs(d)
    slots = np.arange(rows.shape[0], dtype=np.int32)
    ids = np.broadcast_to(np.where(slots < count, slots, -1),
                          (LANES, rows.shape[0])).copy()
    tq, tr = torch.from_numpy(q), torch.from_numpy(rows)
    got = ops.rerank_l2_shared(tq, tr, count).numpy()
    want = ops.rerank_l2_rows(tq, tr, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:, count:] == INF).all()
    assert (got[:, :count] < INF).all()


@pytest.mark.parametrize("count", [-1, 38])
def test_rerank_shared_count_outside_rows_raises(count):
    q, rows = _shared_inputs(48)
    with pytest.raises(ValueError):
        ops.rerank_l2_shared(torch.from_numpy(q), torch.from_numpy(rows),
                             count)


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna`` rounds it: half away from zero at
    the 13th mantissa bit, the low 13 bits cut."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _truncate32(x):
    """float64 sums to float32 toward zero: the tensor core's fp32
    accumulation, taken at its worst (a truncating add)."""
    t = x.astype(np.float32)
    over = np.abs(t.astype(np.float64)) > np.abs(x)
    t[over] = np.nextafter(t[over], np.float32(0))
    return t


def _shared_guard_mirror(q, rows, count, warps_k: int):
    """The CUDA kernel's arithmetic for ``rerank_l2_shared`` on the host:
    both sides shifted by the mean of the first min(count, 16) rows; D cut
    in stages of 32 x ``warps_k`` elements, K-warp w summing elements 32 w
    .. 32 w + 31 of each: each norm 8 fmaf squares a lane a stage, a tree
    over 4 lanes, the stages added in order; q'.x' as lo.hi + hi.lo + hi.hi
    TF32 products in steps of 8 elements (lane t: elements 4t, 4t + 1 and
    then 4t + 2, 4t + 3 of each 16), a fresh truncating accumulator a
    stage added into an fp32 total; the K-warps' sums combined in a
    pairwise tree.  Returns (d^, S = ||q'||^2 + ||x'||^2, the guard's
    flags with ``ops.SHARED_TAU``)."""
    f32 = np.float32
    x = rows[:count]
    d = q.shape[1]
    c = np.zeros(d, f32)
    for r in range(min(count, 16)):
        c = (c + x[r]).astype(f32)
    c = (c * f32(1.0 / min(count, 16))).astype(f32)
    qs, xs = (q - c).astype(f32), (x - c).astype(f32)
    halves = [(_tf32(v), _tf32((v - _tf32(v)).astype(f32))) for v in (qs, xs)]
    (qh, ql), (xh, xl) = halves
    tot = np.zeros((warps_k, q.shape[0], count), f32)
    nq = np.zeros((warps_k, q.shape[0]), f32)
    nx = np.zeros((warps_k, count), f32)
    for s0 in range(0, d, 32):
        w = (s0 // 32) % warps_k
        acc = np.zeros_like(tot[w])
        for j in range(2):
            for step in range(2):
                ks = [s0 + 16 * j + 4 * t + 2 * step + e for t in range(4)
                      for e in range(2)]
                for a, b in ((ql, xh), (qh, xl), (qh, xh)):
                    acc = _truncate32(acc.astype(np.float64) +
                                      a[:, ks].astype(np.float64) @
                                      b[:, ks].astype(np.float64).T)
        tot[w] = (tot[w] + acc).astype(f32)
        for v, n in ((qs, nq[w]), (xs, nx[w])):
            lanes = np.zeros((v.shape[0], 4), f32)
            for j in range(2):
                for e in range(4):
                    col = v[:, [s0 + 16 * j + 4 * t + e for t in range(4)]]
                    lanes = (lanes.astype(np.float64) +
                             col.astype(np.float64) ** 2).astype(f32)
            pair = (lanes[:, [0, 2]] + lanes[:, [1, 3]]).astype(f32)
            n[:] = (n + (pair[:, 0] + pair[:, 1]).astype(f32)).astype(f32)

    def tree(v):
        v = list(v)
        h = 1
        while h < len(v):
            for i in range(0, len(v) - h, 2 * h):
                v[i] = (v[i] + v[i + h]).astype(f32)
            h *= 2
        return v[0]
    sn = (tree(nq)[:, None] + tree(nx)[None]).astype(f32)
    dot = tree(tot)
    dh = (sn.astype(np.float64) - 2.0 * dot.astype(np.float64)).astype(f32)
    return dh, sn, dh <= (f32(ops.SHARED_TAU) * sn).astype(f32)


def _guard_case(case: str):
    """(queries, rows) at D = 768: FineWeb-like rows (24 clusters of
    scale 3 and noise 1, norms ~7,680) against a query wave from the same
    mixture or against themselves, or near-duplicates of one vector
    queried by noisy copies."""
    rng = np.random.default_rng(768)
    d, n = 768, 128
    if case == "near_duplicates":
        rows = (rng.standard_normal(d) + 0.05 * rng.standard_normal(
            (n, d))).astype(np.float32)
        q = rows[rng.integers(0, n, 48)] + 0.05 * rng.standard_normal(
            (48, d))
        return q.astype(np.float32), rows
    cents = rng.standard_normal((24, d)) * 3
    draw = lambda m: (cents[rng.integers(0, 24, m)] +
                      rng.standard_normal((m, d))).astype(np.float32)
    rows = draw(n)
    return (rows[:48].copy() if case == "fineweb_self" else draw(48)), rows


@pytest.mark.parametrize("warps_k", [1, 8])
@pytest.mark.parametrize("case", ["fineweb_queries", "fineweb_self",
                                  "near_duplicates"])
def test_rerank_shared_guard_arithmetic(case, warps_k):
    """The card's guard rehearsed for both tile shapes (D summed by one
    warp, or split over eight): with ``ops``' tau, every pair the shifted
    3xTF32 form leaves unflagged is within rtol 1e-5 / atol 1e-3 of the
    reference's rerank (vmapped over the lanes, rows shared); the form
    stays within ``SHARED_EPS`` S of the exact d; every pair with exact d
    under (tau - 2 eps) S is flagged (each self-pair); and on the
    near-duplicates, which the shift spreads apart, almost none is."""
    q, rows = _guard_case(case)
    want = np.asarray(jax.vmap(jref.rerank_l2_ref, in_axes=(0, None))(
        jnp.asarray(q), jnp.asarray(rows)))
    dh, sn, flag = _shared_guard_mirror(q, rows, rows.shape[0], warps_k)
    exact = ((q.astype(np.float64)[:, None] -
              rows.astype(np.float64)[None]) ** 2).sum(-1)
    assert np.abs(dh - exact).max() <= ops.SHARED_EPS * sn.min() or \
        (np.abs(dh - exact) <= ops.SHARED_EPS * sn).all()
    np.testing.assert_allclose(dh[~flag], want[~flag], rtol=ops.RERANK_RTOL,
                               atol=ops.RERANK_ATOL)
    near = exact <= (ops.SHARED_TAU - 2 * ops.SHARED_EPS) * sn
    assert flag[near].all()
    assert ops.SHARED_TAU == ops.SHARED_EPS * (1 + 1 / ops.RERANK_RTOL)
    if case == "fineweb_self":
        assert flag[np.arange(48), np.arange(48)].all()
    if case == "near_duplicates":
        assert flag.mean() <= 0.01


def test_merge_buffer_hits_scores_through_the_shared_entry(monkeypatch):
    """FreshDiskANN's buffer scan calls ``rerank_l2_shared`` once a wave
    with the buffer and its count, and the by-id entry not at all; the
    merge keeps each lane's k smallest of its hits and the buffered rows
    (virtual ids ``n_max + slot``)."""
    from repro_torch.core import Engine, preset
    q, rows = _shared_inputs(48, s=6)
    eng = Engine(preset("freshdiskann", dim=48, buffer_max=6, k=4),
                 device="cpu")
    state = types.SimpleNamespace(
        buf_vecs=torch.from_numpy(rows), buf_count=4,
        store=types.SimpleNamespace(n_max=100))
    ids = torch.tensor([[3, 7, -1, -1], [1, 2, 9, 11], [5, -1, -1, -1]],
                       dtype=torch.int32)
    dists = torch.tensor([[10.0, 900.0, INF, INF],
                          [50.0, 60.0, 70.0, 80.0],
                          [2000.0, INF, INF, INF]])
    calls = []
    shared = ops.rerank_l2_shared

    def counting(q_, rows_, count):
        calls.append((tuple(q_.shape), rows_.data_ptr(), count))
        return shared(q_, rows_, count)

    def by_id(*args):
        raise AssertionError("the buffer scan reached rerank_l2_rows")
    monkeypatch.setattr(ops, "rerank_l2_shared", counting)
    monkeypatch.setattr(ops, "rerank_l2_rows", by_id)
    tq = torch.from_numpy(q)
    got_i, got_d = eng._merge_buffer_hits(state, tq, ids, dists)
    assert calls == [((LANES, 48), state.buf_vecs.data_ptr(), 4)]
    bd = ref.rerank_l2_shared_ref(tq, state.buf_vecs, 4)[:, :4]
    for b in range(LANES):
        cand = [(float(d_), int(i_)) for d_, i_ in zip(dists[b], ids[b])
                if i_ >= 0]
        cand += [(float(bd[b, s]), 100 + s) for s in range(4)]
        cand.sort(key=lambda c: c[0])
        assert got_i[b].tolist() == [i_ for _, i_ in cand[:4]]
        assert got_d[b].tolist() == [d_ for d_, _ in cand[:4]]
    assert got_i[0, 0] == 101 and got_d[0, 0] == 0.0     # lane 0 is row 1


def test_plain_versions_keep_dtype():
    gen = torch.Generator().manual_seed(0)
    lut = torch.rand((2, 8, 256), dtype=torch.float64, generator=gen)
    codes = torch.randint(0, 256, (2, 5, 8), dtype=torch.uint8,
                          generator=gen)
    assert ops.adc_distance(lut, codes).dtype == torch.float64
    q = torch.rand((2, 16), dtype=torch.float64, generator=gen)
    xs = torch.rand((2, 3, 16), dtype=torch.float64, generator=gen)
    assert ops.rerank_l2(q, xs).dtype == torch.float64


def test_cpu_tensors_never_launch():
    """CPU tensors go to the plain versions, with or without the A/B
    switch, and leave every launch count at 0."""
    ops.reset_launches()
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in _merge_inputs(rng, 10, 30)]
    ops.pool_merge(*args)
    with ops.plain_on_device():
        ops.adc_distance(torch.ones((1, 4, 256)),
                         torch.zeros((1, 2, 4), dtype=torch.uint8))
    ops.rerank_l2(torch.ones((1, 8)), torch.zeros((1, 2, 8)))
    ops.casr_rerank(torch.ones((1, 8)), torch.zeros((4, 8)),
                    torch.tensor([[0, 2, 1, -1]], dtype=torch.int32), k=2,
                    s=2)
    ops.rerank_l2_shared(torch.ones((1, 8)), torch.zeros((3, 8)), 2)
    st = tcache.init_cache(16, 4, "navis", jr.PRNGKey(0), device="cpu")
    tables = [getattr(st, n) for n in tcache.TABLES]
    ops.cache_replay(st.policy, tables,
                     torch.tensor([[1, 2, 1, -1]], dtype=torch.int32))
    ops.cache_ops(st.policy, tables, torch.tensor([3, -1, 1],
                                                  dtype=torch.int32))
    ent = EntranceGraph(ids=torch.tensor([-1, 0, 1], dtype=torch.int32),
                        edges=torch.tensor([[1, 2], [2, -1], [1, -1]],
                                           dtype=torch.int32),
                        count=2,
                        main_to_ent=torch.zeros(2, dtype=torch.int32))
    tsearch.entrance_search(ent, torch.ones((1, 4, 256)),
                            torch.zeros((2, 4), dtype=torch.uint8),
                            n_entry=1, pool_size=2)
    assert ops.launches == {"pool_merge": 0, "adc_distance": 0,
                            "rerank_l2": 0, "rerank_l2_rows": 0,
                            "rerank_l2_shared": 0, "casr_rerank": 0,
                            "cache_replay": 0, "cache_ops": 0,
                            "entrance_search": 0}


def test_unsupported_devices_raise():
    """Neither a meta tensor nor a CPU/meta mix falls back to a plain
    version."""
    with pytest.raises(ValueError):
        ops.rerank_l2(torch.empty((1, 8), device="meta"),
                      torch.empty((1, 2, 8), device="meta"))
    with pytest.raises(ValueError):
        ops.adc_distance(torch.ones((1, 4, 256)),
                         torch.empty((1, 2, 4), dtype=torch.uint8,
                                     device="meta"))


def test_device_rule():
    """Entry points default to cuda and raise without a card."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((path.name, mod))
    assert not bad, bad
