"""GVS search: entry-point selection -> on-disk beam traversal (port of
``repro/core/search.py``).

The traversal is the paper's ② stage: greedy beam search over the on-disk
graph with in-memory PQ distances, loading only edgelist pages under the
decoupled layout.  The reference runs one query per ``lax.while_loop`` and
gets a wave's concurrency from ``vmap``; the port writes the wave out
batch-first.  Every tensor carries a leading lane dimension ``[B]``, the
loop is bounded by ``max_hops``, and a per-lane ``active`` mask stands in
for the per-lane loop condition: a lane that has converged never changes
again (pool, visited sets, trace, counters and ``hops``), so each lane
returns exactly what the reference's ``vmap`` returns for it.

Both cache modes of the reference are ported.  In the frozen mode (both
fan-outs and the build) the lanes probe one cache snapshot with
:func:`cache.lookup` and record the pages they charge, in order, for a
later ordered replay.  In the threaded mode (the reference's
``frozen_cache=False``: ``Engine.search`` / ``insert`` and their batches)
one lane runs against a cache handle (:func:`cache.open`), and each hop's
charged pages go through its ``access`` in beam-slot order (on the card,
one ``cache_ops`` launch a hop), so a page that an earlier access of the
same traversal evicted misses as it does in the reference.  Per hop the ADC
scoring and the pool merge go through the kernel layer
(:mod:`repro_torch.kernels.ops`).

Both layouts are ported.  Under the packed layout every page read drags
its records' vectors along: they are charged as wasted vector bytes (the
engine's classifier moves the useful share later) and the beam's vectors
are marked in ``vec_loaded``.  :func:`full_rerank` is the non-CASR
baseline: it scores every pool candidate by id through
``rerank_l2_rows`` (one launch a wave) and charges the decoupled
layout's vector reads.  ``visited="bitmap"`` swaps the hash sets for the
reference's bitmaps, and a caller may seed the page buffer with a raw
``[B, P_max]`` bool map (a merge shares one across its inserts), which
comes back raw.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.core import cache as cache_mod
from repro_torch.core import visited as visited_mod
from repro_torch.core.entrance import EntranceGraph
from repro_torch.core.iomodel import IOCounters, PAGE_BYTES
from repro_torch.core.layout import GraphStore, LayoutSpec
from repro_torch.kernels import ops as kernel_ops

INF = 3.4e38
_INT32_MAX = 2 ** 31 - 1


def _lut_adc(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor):
    """ADC of each lane's LUT against the code rows of ``ids`` [B, C]."""
    return kernel_ops.adc_distance(lut, codes[ids.long()])


def entrance_search(ent: EntranceGraph, lut: torch.Tensor,
                    codes: torch.Tensor, *, n_entry: int,
                    pool_size: int = 32, max_hops: int = 64,
                    visited: str = "hash"):
    """In-memory beam search over the entrance graph, one lane per LUT
    (``lut`` [B, M, 256]).  Returns (entry ids [B, n_entry] into the main
    graph, explored main ids E_ent [B, pool_size], their PQ distances).
    ``visited="bitmap"`` keeps the expanded set as a dense bitmap (the
    same answers: the hash set never overflows here)."""
    main, pool_d, _ = entrance_lanes(ent, lut, codes, pool_size=pool_size,
                                     max_hops=max_hops, visited=visited)
    return main[:, :n_entry], main, pool_d


def entrance_lanes(ent: EntranceGraph, lut: torch.Tensor,
                   codes: torch.Tensor, *, pool_size: int, max_hops: int,
                   visited: str):
    """:func:`entrance_search`'s (E_ent, distances) and each lane's
    iteration count [B] int32.  On the card it is one ``entrance_search``
    launch with no host read: the counters ``entry_iters`` (the largest
    lane count, the iterations the loop runs) and ``entry_lane_steps``
    (their sum) are read at the next :func:`spans.sync`.  CPU tensors, and
    :func:`kernel_ops.plain_on_device`, run the host loop, the kernel's
    plain version."""
    if kernel_ops.runs_plain(lut, codes, ent.ids, ent.edges):
        return _entrance_loop(ent, lut, codes, pool_size=pool_size,
                              max_hops=max_hops, visited=visited)
    main, pool_d, hops, tally = kernel_ops.entrance_search(
        lut, codes, ent.ids, ent.edges, pool_size=pool_size,
        max_hops=max_hops)
    spans.count_later(("entry_iters", "entry_lane_steps"), tally)
    return main, pool_d, hops


def _entrance_loop(ent: EntranceGraph, lut: torch.Tensor,
                   codes: torch.Tensor, *, pool_size: int, max_hops: int,
                   visited: str):
    """The entrance search as a host loop over all lanes, each iteration
    through ``adc_distance`` and ``pool_merge``: (E_ent, distances, lane
    iterations), as :func:`entrance_lanes`.  Counts ``entry_iters`` an
    iteration and ``entry_lane_steps`` at the next sync."""
    b = lut.shape[0]
    dev = lut.device
    c = ent.c_max
    # seed: the first live entry slot
    seed = spans.read(torch.argmax((ent.ids >= 0).to(torch.int32)), "seed")
    seed_main = spans.read(ent.ids[seed], "seed")
    pool_idx = torch.full((b, pool_size), -1, dtype=torch.int32, device=dev)
    pool_d = torch.full((b, pool_size), INF, device=dev)
    pool_idx[:, 0] = seed
    if seed_main >= 0:
        seed_ids = torch.full((b, 1), seed_main, dtype=torch.int32,
                              device=dev)
        pool_d[:, :1] = _lut_adc(lut, codes, seed_ids)
    expanded = (visited_mod.make_dense(c, b, dev) if visited == "bitmap"
                else visited_mod.make_hash(min(max_hops, c), b, dev))
    unexp = pool_idx >= 0
    hops = torch.zeros((b,), dtype=torch.int32, device=dev)
    active = unexp.any(1) & (max_hops > 0)
    while spans.read(active.any(), "loop"):
        spans.count("entry_iters")
        cand_d = torch.where(unexp, pool_d, INF)
        best = cand_d.argmin(dim=1, keepdim=True)
        v = pool_idx.gather(1, best)[:, 0]
        expanded = visited_mod.add(expanded, v, active)
        nbrs = ent.edges[v.clamp(min=0).long()]                  # [B, R_ent]
        in_pool = (nbrs[:, :, None] == pool_idx[:, None, :]).any(-1)
        valid = (nbrs >= 0) & ~visited_mod.contains(expanded, nbrs) & \
            ~in_pool
        main_ids = ent.ids[nbrs.clamp(min=0).long()]
        d = torch.where(valid & (main_ids >= 0),
                        _lut_adc(lut, codes, main_ids.clamp(min=0)), INF)
        new_d, new_idx = kernel_ops.pool_merge(
            pool_d, pool_idx, d, torch.where(valid, nbrs, -1))
        act = active[:, None]
        pool_d = torch.where(act, new_d, pool_d)
        pool_idx = torch.where(act, new_idx, pool_idx)
        unexp = torch.where(
            act, (pool_idx >= 0) & ~visited_mod.contains(expanded, pool_idx),
            unexp)
        hops += active.to(hops.dtype)
        active = (hops < max_hops) & unexp.any(1)
    spans.count_later(("entry_lane_steps",), hops.sum())
    main = torch.where(pool_idx >= 0,
                       ent.ids[pool_idx.clamp(min=0).long()], -1)
    return main, pool_d, hops


# ---------------------------------------------------------------------------
# On-disk traversal
# ---------------------------------------------------------------------------

class TraverseResult(NamedTuple):
    pool_ids: torch.Tensor       # [B, pool] main ids sorted by PQ distance
    pool_dists: torch.Tensor     # [B, pool]
    hops: torch.Tensor           # [B] int32
    counters: IOCounters         # [B]
    # pages this traversal read: a visited set, or a raw [B, P_max] bool
    # map when the caller seeded one (or in bitmap mode)
    page_seen: visited_mod.VisitedSet | torch.Tensor
    # frozen mode only (None in the threaded mode): charged page accesses
    trace: torch.Tensor | None   # [B, max_hops * W] int32, -1 padded
    trace_n: torch.Tensor | None  # [B] int32 valid trace entries
    vec_loaded: visited_mod.VisitedSet   # vectors dragged in (packed)


def _charge_page_read(counters: IOCounters, spec: LayoutSpec,
                      n: torch.Tensor) -> IOCounters:
    """Account ``n`` 4 KiB page reads from the slow tier.  A packed page
    carries ``packed_per_page`` records: their vectors are charged as
    wasted, provisionally (the engine's classifier reclassifies the useful
    share)."""
    if spec.kind == "packed":
        per = spec.packed_per_page
        payload = per * spec.packed_record_bytes
        return dataclasses.replace(
            counters,
            read_requests=counters.read_requests + n,
            edge_bytes_read=counters.edge_bytes_read +
            n * (per * spec.edgelist_bytes),
            wasted_vec_bytes_read=counters.wasted_vec_bytes_read +
            n * (per * spec.vector_bytes),
            pad_bytes_read=counters.pad_bytes_read +
            n * (PAGE_BYTES - payload))
    per = spec.edgelists_per_page
    payload = per * spec.edgelist_bytes
    return dataclasses.replace(
        counters,
        read_requests=counters.read_requests + n,
        edge_bytes_read=counters.edge_bytes_read + n * payload,
        pad_bytes_read=counters.pad_bytes_read + n * (PAGE_BYTES - payload))


def fetch_edgelists(store: GraphStore, spec: LayoutSpec,
                    cache: cache_mod.CacheState | cache_mod.Handle,
                    counters: IOCounters,
                    page_seen: visited_mod.VisitedSet, ids: torch.Tensor,
                    valid: torch.Tensor, trace: torch.Tensor | None,
                    trace_n: torch.Tensor | None):
    """Read the edge pages backing each lane's beam ``ids`` [B, W].

    A page is charged if its slot is valid, this traversal has not read it
    yet (``page_seen``) and no earlier valid slot of the beam holds it;
    the rest are free.  Against a snapshot ``cache`` (the reference's
    frozen branch) hits come from :func:`cache.lookup` and the charged
    pages are appended to ``trace`` (``[B, T + 1]``; the last column takes
    the writes of uncharged slots) at ``trace_n`` in slot order.  Against
    a cache handle (the threaded branch, one lane) the charged pages are
    accessed in slot order, and ``trace`` stays None.  Returns
    (edges [B, W, R], counters, page_seen, trace, trace_n).
    """
    w = ids.shape[1]
    safe = ids.clamp(min=0).long()
    pages = store.edge_page[safe]                                 # [B, W]
    ar = torch.arange(w, device=ids.device)
    eq_earlier = (pages[:, :, None] == pages[:, None, :]) & \
        valid[:, None, :] & (ar[None, :] < ar[:, None])
    charged = valid & ~visited_mod.contains(page_seen, pages) & \
        ~eq_earlier.any(-1)
    n_charged = charged.sum(1)
    if not isinstance(cache, cache_mod.CacheState):
        # the lane's slots in order, -1 where uncharged: the accesses run
        # as the reference's scan over the beam issues them
        n_hit = cache.access(torch.where(charged, pages, -1)).to(
            n_charged.dtype)
    else:
        hit = cache_mod.lookup(cache, pages.clamp(min=0)) & charged
        n_hit = hit.sum(1)
        dump = trace.shape[1] - 1
        pos = torch.where(charged, trace_n[:, None].long() +
                          charged.cumsum(1) - 1, dump)
        trace = trace.scatter(1, pos, torch.where(charged, pages, -1))
        trace_n = trace_n + n_charged.to(trace_n.dtype)
    n_miss = n_charged - n_hit
    counters = dataclasses.replace(
        counters, cache_hits=counters.cache_hits + n_hit,
        cache_misses=counters.cache_misses + n_miss)
    counters = _charge_page_read(counters, spec, n_miss)
    page_seen = visited_mod.add(page_seen, pages, valid)
    edges = torch.where(valid[..., None], store.edges[safe], -1)
    return edges, counters, page_seen, trace, trace_n


def make_traversal_state(*, beam_width: int, max_hops: int, batch: int,
                         device, pool_size: int = 0, visited: str = "hash",
                         n_max: int = 0, p_max: int = 0,
                         visited_capacity: int | None = None):
    """The per-lane state ``disk_traverse`` carries, and the one place its
    capacity recipe lives: expansion marks at most ``beam_width`` ids and
    pages per hop for at most ``max_hops`` hops, so ``max_hops *
    beam_width`` bounds ``expanded`` and ``page_seen`` exactly;
    ``vec_loaded`` also takes the pool a full rerank marks.  Bitmap mode
    uses ``[B, n_max]`` / ``[B, p_max]`` bitmaps instead.  Returns
    (expanded, vec_loaded, page_seen, trace [B, max_hops * beam_width +
    1]); the trace's last column takes the writes of uncharged slots."""
    cap = (visited_capacity if visited_capacity is not None
           else max_hops * beam_width)
    if visited == "bitmap":
        sets = (visited_mod.make_dense(n_max, batch, device),
                visited_mod.make_dense(n_max, batch, device),
                visited_mod.make_dense(p_max, batch, device))
    else:
        sets = (visited_mod.make_hash(cap, batch, device),
                visited_mod.make_hash(cap + pool_size, batch, device),
                visited_mod.make_hash(cap, batch, device))
    return sets + (torch.full((batch, max_hops * beam_width + 1), -1,
                              dtype=torch.int32, device=device),)


def _wrap_page_seen(page_seen, default: visited_mod.VisitedSet,
                    visited: str):
    """The caller's page buffer as a visited set, and whether the result
    goes back raw (a seeded raw ``[B, P_max]`` map, or bitmap mode)."""
    if page_seen is None:
        return default, visited == "bitmap"
    if isinstance(page_seen, (visited_mod.DenseVisited,
                              visited_mod.HashVisited)):
        return page_seen, False
    return visited_mod.DenseVisited(page_seen), True


def empty_page_seen(store: GraphStore, *, visited: str = "hash",
                    max_hops: int, beam_width: int):
    """One lane's empty page buffer, of the kind ``disk_traverse`` would
    create (a raw ``[P_max]`` bitmap in bitmap mode), for a caller that
    hands one back for an operation that traversed nothing."""
    _, _, ps, _ = make_traversal_state(
        beam_width=beam_width, max_hops=max_hops, batch=1,
        device=store.device, visited=visited, n_max=store.n_max,
        p_max=store.p_max)
    if visited == "bitmap":
        return ps.bits[0]
    return visited_mod.HashVisited(ps.keys[0], ps.count[0], ps.overflow[0])


def traversal_state_bytes(*, n_max: int, p_max: int, pool_size: int,
                          beam_width: int, max_hops: int,
                          visited: str = "hash",
                          frozen: bool = False) -> int:
    """Bytes of one lane's traversal state: ``expanded``, ``vec_loaded``
    and ``page_seen``, plus the trace in frozen (fan-out) mode, accounted
    over the structures :func:`make_traversal_state` hands the traversal,
    built on the meta device (nothing is allocated).  The port's trace
    has one column more than the reference's (the sink for uncharged
    slots), so in frozen mode this is 4 bytes above the reference's."""
    *sets, trace = make_traversal_state(
        beam_width=beam_width, max_hops=max_hops, batch=1,
        device=torch.device("meta"), pool_size=pool_size, visited=visited,
        n_max=n_max, p_max=p_max)
    total = sum(visited_mod.nbytes(vs) for vs in sets)
    return total + (trace[0].numel() * trace.element_size() if frozen else 0)


def disk_traverse(store: GraphStore, spec: LayoutSpec, lut: torch.Tensor,
                  codes: torch.Tensor,
                  cache: cache_mod.CacheState | cache_mod.Handle,
                  counters: IOCounters, entry_ids: torch.Tensor, *,
                  pool_size: int, beam_width: int = 4, max_hops: int = 512,
                  page_seen=None, visited: str = "hash",
                  visited_capacity: int | None = None) -> TraverseResult:
    """Greedy beam search, one lane per LUT.

    ``cache`` is a snapshot (frozen mode: the lanes record traces) or a
    handle from :func:`cache.open` (threaded mode, the reference's
    ``frozen_cache=False``: one lane, the cache evolves in place, no
    trace).  ``entry_ids`` [B, n_entry] main ids (-1 padded);
    ``counters`` [B].  A lane converges when no unexpanded candidate
    remains in its top ``pool_size``.  ``page_seen`` seeds the page buffer
    (a visited set, or a raw ``[B, P_max]`` bool map, handed back raw).
    ``visited`` picks hash sets or bitmaps; ``visited_capacity`` overrides
    the exact mark bound ``max_hops * beam_width`` (smaller values
    saturate: a lane may re-expand vertices, counted in
    ``visited_overflow``).
    """
    b, n_entry = entry_ids.shape
    threaded = not isinstance(cache, cache_mod.CacheState)
    if threaded and b != 1:
        raise ValueError(f"the threaded traversal runs one lane, got {b}")
    dev = lut.device
    safe_e = entry_ids.clamp(min=0)
    e_valid = entry_ids >= 0
    e_d = torch.where(e_valid, _lut_adc(lut, codes, safe_e), INF)
    order = torch.sort(e_d, dim=1, stable=True).indices
    k = min(n_entry, pool_size)
    pool_ids = torch.full((b, pool_size), -1, dtype=torch.int32, device=dev)
    pool_d = torch.full((b, pool_size), INF, device=dev)
    top = order[:, :k]
    pool_ids[:, :k] = torch.where(e_valid.gather(1, top),
                                  entry_ids.gather(1, top), -1)
    pool_d[:, :k] = e_d.gather(1, top)

    expanded, vec_loaded, default_ps, trace = make_traversal_state(
        beam_width=beam_width, max_hops=max_hops, batch=b, device=dev,
        pool_size=pool_size, visited=visited, n_max=store.n_max,
        p_max=store.p_max, visited_capacity=visited_capacity)
    page_seen, raw_pages = _wrap_page_seen(page_seen, default_ps, visited)
    ovf0 = visited_mod.overflow(page_seen)
    t = max_hops * beam_width
    trace_n = torch.zeros((b,), dtype=torch.int32, device=dev)
    if threaded:
        trace = trace_n = None
    unexp = pool_ids >= 0
    hops = torch.zeros((b,), dtype=torch.int32, device=dev)
    active = unexp.any(1) & (max_hops > 0)
    while spans.read(active.any(), "loop"):
        spans.count("traverse_iters")
        spans.count("traverse_lanes", b)    # converged lanes included
        act = active[:, None]
        cand_d = torch.where(unexp, pool_d, INF)
        sd, sel = torch.sort(cand_d, dim=1, stable=True)
        beam = torch.where(sd[:, :beam_width] < INF,
                           pool_ids.gather(1, sel[:, :beam_width]), -1)
        beam_valid = (beam >= 0) & act
        expanded = visited_mod.add(expanded, beam, beam_valid)
        edges, counters, page_seen, trace, trace_n = fetch_edgelists(
            store, spec, cache, counters, page_seen, beam, beam_valid,
            trace, trace_n)
        if spec.kind == "packed":
            vec_loaded = visited_mod.add(vec_loaded, beam, beam_valid)

        # the explored pool is a set: candidates evicted from it may be
        # re-scored later; only expansion is permanent (Vamana semantics)
        nbrs = edges.reshape(b, -1)                               # [B, W*R]
        in_pool = (nbrs[:, :, None] == pool_ids[:, None, :]).any(-1)
        nvalid = (nbrs >= 0) & ~visited_mod.contains(expanded, nbrs) & \
            ~in_pool
        # dedupe the flat neighbor list, first occurrence wins (stable sort)
        key_ = torch.where(nvalid, nbrs, _INT32_MAX)
        sorted_key, sort_idx = torch.sort(key_, dim=1, stable=True)
        first = torch.ones_like(nvalid)
        first[:, 1:] = sorted_key[:, 1:] != sorted_key[:, :-1]
        nvalid &= torch.zeros_like(nvalid).scatter(1, sort_idx, first)
        nd = torch.where(nvalid, _lut_adc(lut, codes, nbrs.clamp(min=0)),
                         INF)
        new_d, new_ids = kernel_ops.pool_merge(
            pool_d, pool_ids, nd, torch.where(nvalid, nbrs, -1))
        pool_d = torch.where(act, new_d, pool_d)
        pool_ids = torch.where(act, new_ids, pool_ids)
        unexp = torch.where(
            act, (pool_ids >= 0) & ~visited_mod.contains(expanded, pool_ids),
            unexp)
        step = active.to(torch.int64)
        counters = dataclasses.replace(counters, hops=counters.hops + step)
        hops += active.to(hops.dtype)
        active = (hops < max_hops) & unexp.any(1)
    ovf = (visited_mod.overflow(expanded) + visited_mod.overflow(vec_loaded)
           + visited_mod.overflow(page_seen) - ovf0).to(torch.int64)
    counters = dataclasses.replace(
        counters, visited_overflow=counters.visited_overflow + ovf)
    return TraverseResult(pool_ids, pool_d, hops, counters,
                          page_seen.bits if raw_pages else page_seen,
                          None if threaded else trace[:, :t], trace_n,
                          vec_loaded)


# ---------------------------------------------------------------------------
# Full-rerank baseline
# ---------------------------------------------------------------------------

def full_rerank(store: GraphStore, spec: LayoutSpec, q: torch.Tensor,
                res: TraverseResult, counters: IOCounters, *, k: int):
    """Exact-rerank every candidate of each lane's pool ``res.pool_ids``
    [B, P] (the non-CASR baseline) -> (ids [B, k], dists [B, k],
    vec_loaded, counters).

    Under the packed layout the vectors rode along with the edge pages (no
    extra I/O); under the decoupled layout each valid candidate costs one
    vector read, charged as wasted until the classifier moves the useful
    share (the naive-unpacking strawman of §3.1), and the pool joins
    ``vec_loaded``.  The rows are scored by id in one ``rerank_l2_rows``
    launch, then sorted stably (ties keep pool order)."""
    ids = res.pool_ids
    vec_loaded = res.vec_loaded
    if spec.kind == "decoupled":
        valid = ids >= 0
        n = valid.sum(1)
        counters = dataclasses.replace(
            counters, read_requests=counters.read_requests + n,
            wasted_vec_bytes_read=counters.wasted_vec_bytes_read +
            n * (spec.vector_pages_per_read * PAGE_BYTES))
        marked = visited_mod.add(vec_loaded, ids, valid)
        ovf = visited_mod.overflow(marked) - visited_mod.overflow(vec_loaded)
        counters = dataclasses.replace(
            counters, visited_overflow=counters.visited_overflow +
            ovf.to(torch.int64))
        vec_loaded = marked
    d = kernel_ops.rerank_l2_rows(q.contiguous(), store.vectors,
                                  ids.contiguous())
    d, order = torch.sort(d, dim=1, stable=True)
    return ids.gather(1, order)[:, :k], d[:, :k], vec_loaded, counters
