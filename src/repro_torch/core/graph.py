"""Proximity-graph construction (Vamana lineage) + quality helpers (port
of ``repro/core/graph.py``).

The base index is built with the insertion machinery: after a small
fully-connected bootstrap, vertices are added in blocks.  Each block
position-seeks as one wave on a frozen snapshot, is exact-reranked
against the in-memory build vectors and RobustPrune(α)-ed, then wired
in block order by :func:`insert.wire_block` (the reference's per-vertex
``structural_update`` scan, committed in conflict-free rounds).  A refinement
pass re-seeks every vertex on the finished graph at α = 1.2 and rewires.

Two departures from the reference, both in the build only: the last
block of a pass holds just the remaining vertices (the reference pads it
with zero vectors, wires them, then truncates them away, which can leave
their prunes in real rows), and the refinement's reciprocal wiring runs
in rounds keyed by target vertex (pairs with different targets touch
different rows and commute; one target's pairs keep their order).  The
build owns its store and updates its tensors in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.core import cache as cache_mod
from repro_torch.core import insert as insert_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core.iomodel import IOCounters
from repro_torch.core.layout import (GraphStore, LayoutSpec,
                                     assign_initial_pages, empty_store)

INF = 3.4e38
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# Ground truth + recall
# ---------------------------------------------------------------------------

def brute_force_topk(queries: torch.Tensor, vectors: torch.Tensor, n_live,
                     k: int, chunk: int = 256) -> torch.Tensor:
    """Exact top-k ids per query ([Q, D] -> [Q, k] int32).  ``n_live`` is a
    prefix count or an [N] bool live mask."""
    vnorm = (vectors * vectors).sum(1)
    if isinstance(n_live, torch.Tensor) and n_live.dtype == torch.bool:
        live = n_live
    else:
        live = torch.arange(vectors.shape[0], device=vectors.device) < n_live
    out = []
    for s in range(0, queries.shape[0], chunk):
        d = vnorm[None] - 2.0 * (queries[s:s + chunk] @ vectors.T)
        d = torch.where(live[None], d, INF)
        out.append(torch.sort(d, dim=1, stable=True).indices[:, :k])
    return torch.cat(out).to(torch.int32)


def recall_at_k(pred: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean |pred ∩ truth| / k over queries.  pred, truth: [Q, k]."""
    hits = (pred[:, :, None] == truth[:, None, :]) & \
        (truth[:, None, :] >= 0)
    return float(hits.any(dim=1).float().mean())


def medoid(vectors: torch.Tensor, n_live: int) -> int:
    """Vertex closest to the centroid of the live prefix."""
    live = vectors[:n_live]
    c = live.mean(dim=0)
    return int(((live - c) ** 2).sum(1).argmin())


# ---------------------------------------------------------------------------
# RobustPrune (Vamana)
# ---------------------------------------------------------------------------

def robust_prune(q: torch.Tensor, cand_ids: torch.Tensor,
                 cand_d: torch.Tensor, vectors: torch.Tensor, *,
                 alpha: float, r: int) -> torch.Tensor:
    """Diversity-pruned neighbor selection, one lane per row of ``q``.

    Repeatedly keeps the closest unpruned candidate p, then prunes every c
    with α·d(p,c) <= d(q,c).  cand_ids/cand_d [B, C] (exact distances to
    q) -> [B, r] ids (-1 padded).
    """
    cvecs = vectors[cand_ids.clamp(min=0).long()]              # [B, C, D]
    pruned = cand_ids < 0
    kept = []
    for _ in range(r):
        d_masked = torch.where(pruned, INF, cand_d)
        best = d_masked.argmin(dim=1, keepdim=True)
        ok = d_masked.gather(1, best)[:, 0] < INF
        kept.append(torch.where(ok, cand_ids.gather(1, best)[:, 0], -1))
        pvec = cvecs.gather(1, best[:, :, None].expand(-1, 1,
                                                       cvecs.shape[2]))
        d_pc = ((cvecs - pvec) ** 2).sum(-1)                   # [B, C]
        pruned |= ok[:, None] & (alpha * d_pc <= cand_d)
    return torch.stack(kept, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def bootstrap_store(vectors: torch.Tensor, spec: LayoutSpec, n_max: int,
                    n_boot: int) -> GraphStore:
    """Fully-connected clique over the first ``n_boot`` (<= R+1) vectors."""
    dev = vectors.device
    store = empty_store(n_max, spec.dim, spec.r, device=dev)
    idx = torch.arange(n_boot, dtype=torch.int32, device=dev)
    width = min(n_boot - 1, spec.r)
    rows = idx[None].expand(n_boot, n_boot)
    mask = ~torch.eye(n_boot, dtype=torch.bool, device=dev)
    # each row's other vertices, in order
    rows = rows[mask].reshape(n_boot, n_boot - 1)[:, :width]
    store.edges[:n_boot, :width] = rows
    store.vectors[:n_boot] = vectors[:n_boot]
    store.degree[:n_boot] = width
    store = dataclasses.replace(store, count=n_boot)
    return assign_initial_pages(store, spec)


def _seek_wave(store: GraphStore, spec: LayoutSpec, q: torch.Tensor,
               codes: torch.Tensor, codec: pq_mod.PQCodec,
               cache: cache_mod.CacheState, entry_ids: torch.Tensor, *,
               e_pos: int, beam_width: int, max_hops: int) -> torch.Tensor:
    """Position-seek a block of vectors as one frozen-cache wave."""
    b = q.shape[0]
    res = search_mod.disk_traverse(
        store, spec, pq_mod.adc_lut(codec, q), codes, cache,
        IOCounters.zeros((b,), q.device), entry_ids[None].expand(b, -1),
        pool_size=e_pos, beam_width=beam_width, max_hops=max_hops)
    return res.pool_ids


def _build_block(store: GraphStore, spec: LayoutSpec,
                 block_vecs: torch.Tensor, codes: torch.Tensor,
                 sym_tables: torch.Tensor, codec: pq_mod.PQCodec,
                 cache: cache_mod.CacheState, entry_ids: torch.Tensor, *,
                 e_pos: int, alpha: float, beam_width: int,
                 max_hops: int) -> GraphStore:
    """Insert one block: a seek wave on the snapshot, then the structural
    updates in block order (committed in conflict-free rounds)."""
    pool = _seek_wave(store, spec, block_vecs, codes, codec, cache,
                      entry_ids, e_pos=e_pos, beam_width=beam_width,
                      max_hops=max_hops)
    d = torch.where(pool >= 0, pq_mod.exact_l2(
        block_vecs, store.vectors[pool.clamp(min=0).long()]), INF)
    nbrs = robust_prune(block_vecs, pool, d, store.vectors, alpha=alpha,
                        r=store.r)
    return insert_mod.wire_block(store, spec, block_vecs, nbrs, codes,
                                 sym_tables)


def _first_occurrence(keys: torch.Tensor, valid: torch.Tensor):
    """[B, C] mask of the first valid occurrence of each key in its row."""
    k = torch.where(valid, keys.long(), _INT32_MAX)
    sk, idx = torch.sort(k, dim=1, stable=True)
    first = torch.ones_like(valid)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    return torch.zeros_like(valid).scatter(1, idx, first) & valid


def _wire_reverse(store: GraphStore, pv: torch.Tensor, pj: torch.Tensor,
                  chunk: int = 2048):
    """Reciprocal wiring of (vertex v -> neighbor j) pairs in order: add v
    to row j, replacing its farthest entry (exact distance) when full.
    Runs in rounds; round t takes each target's t-th pair."""
    keep = (pj >= 0) & (pj != pv)
    pv, pj = pv[keep].long(), pj[keep].long()
    if pj.numel() == 0:
        return store
    sj, perm = torch.sort(pj, stable=True)
    pos = torch.arange(sj.numel(), device=sj.device)
    new_group = torch.ones_like(sj, dtype=torch.bool)
    new_group[1:] = sj[1:] != sj[:-1]
    start = torch.cummax(torch.where(new_group, pos, 0), 0).values
    rank = pos - start
    edges, degree, vecs = store.edges, store.degree, store.vectors
    for t in range(int(rank.max()) + 1):
        sel = perm[rank == t]
        for c in range(0, sel.numel(), chunk):
            s = sel[c:c + chunk]
            v, j = pv[s], pj[s]
            row = edges[j]
            present = (row == v[:, None]).any(1)
            occupied = row >= 0
            free = (~occupied).to(torch.int8).argmax(1)
            has_free = ~occupied.all(1)
            jvec = vecs[j]
            d_row = torch.where(occupied, pq_mod.exact_l2(
                jvec, vecs[row.clamp(min=0).long()]), -INF)
            worst = d_row.argmax(1)
            d_v = ((jvec - vecs[v]) ** 2).sum(-1)
            write = (has_free | (d_v < d_row.gather(1, worst[:, None])[:, 0])
                     ) & ~present
            tgt = torch.where(has_free, free, worst)
            new_row = row.scatter(1, tgt[:, None], v[:, None].to(row.dtype))
            edges[j] = torch.where(write[:, None], new_row, row)
            degree[j] = degree[j] + (write & has_free).to(degree.dtype)
    return store


def _refine_block(store: GraphStore, spec: LayoutSpec,
                  ids_block: torch.Tensor, codes: torch.Tensor,
                  codec: pq_mod.PQCodec, cache: cache_mod.CacheState,
                  entry_ids: torch.Tensor, *, e_pos: int, alpha: float,
                  beam_width: int, max_hops: int) -> GraphStore:
    """Second Vamana pass over one block: re-seek each vertex on the
    finished graph, RobustPrune(pool ∪ current edges), replace its
    edgelist, and re-add reciprocal edges by exact distance."""
    ids = ids_block.long()
    q = store.vectors[ids]
    pool = _seek_wave(store, spec, q, codes, codec, cache, entry_ids,
                      e_pos=e_pos, beam_width=beam_width, max_hops=max_hops)
    cand = torch.cat([pool, store.edges[ids]], dim=1)
    keep = _first_occurrence(cand, cand >= 0) & (cand != ids[:, None])
    cand = torch.where(keep, cand, -1)
    d = torch.where(keep, pq_mod.exact_l2(
        q, store.vectors[cand.clamp(min=0).long()]), INF)
    new_edges = robust_prune(q, cand, d, store.vectors, alpha=alpha,
                             r=store.r)
    store.edges[ids] = new_edges
    store.degree[ids] = (new_edges >= 0).sum(1).to(store.degree.dtype)
    return _wire_reverse(store, ids.repeat_interleave(store.r),
                         new_edges.reshape(-1))


def build_graph(key: torch.Tensor, vectors: torch.Tensor, n: int,
                spec: LayoutSpec, codec: pq_mod.PQCodec, codes: torch.Tensor,
                *, n_max: int | None = None, e_pos: int = 64,
                alpha: float = 1.2, block: int = 64, beam_width: int = 4,
                max_hops: int = 128, n_entry: int = 4, refine: bool = True,
                progress=None) -> GraphStore:
    """Build the base index over ``vectors[:n]``: an insertion pass at
    α = 1.0, then a refinement pass at ``alpha``.  ``codes`` holds the PQ
    encodings of ``vectors``.  ``progress(stage, done, total)`` is called
    after every block when given."""
    n_max = n_max or vectors.shape[0]
    dev = vectors.device
    sym_tables = pq_mod.sym_tables(codec)
    n_boot = min(spec.r + 1, n)
    store = bootstrap_store(vectors, spec, n_max, n_boot)
    entry_ids = (torch.arange(n_entry, device=dev) % n_boot).to(torch.int32)
    cache = cache_mod.init_cache(store.p_max, 2, "none", jr.PRNGKey(0),
                                 device=dev)
    for pos in range(n_boot, n, block):
        store = _build_block(
            store, spec, vectors[pos:min(pos + block, n)], codes, sym_tables,
            codec, cache, entry_ids, e_pos=e_pos, alpha=1.0,
            beam_width=beam_width, max_hops=max_hops)
        if progress:
            progress("insert", min(pos + block, n), n)
    if refine and n > n_boot:
        order = jr.permutation(key, n).to(dev)
        for start in range(0, n, block):
            store = _refine_block(
                store, spec, order[start:start + block], codes, codec,
                cache, entry_ids, e_pos=e_pos, alpha=alpha,
                beam_width=beam_width, max_hops=max_hops)
            if progress:
                progress("refine", min(start + block, n), n)
    return store


# ---------------------------------------------------------------------------
# Graph invariants
# ---------------------------------------------------------------------------

def check_invariants(store: GraphStore,
                     tombstone: torch.Tensor | None = None) -> dict:
    """Invariant summary; every value must be True for a well-formed graph."""
    n = store.count
    ar = torch.arange(store.n_max, device=store.device)
    live = ar < n
    edges = store.edges
    valid = edges >= 0
    deg = valid.sum(1)
    out = {
        "edges_in_range": bool(torch.where(valid, edges < n, True).all()),
        "no_self_loops": bool(torch.where(valid, edges != ar[:, None],
                                          True).all()),
        "degree_le_r": bool(torch.where(live, deg <= store.r, True).all()),
        "degree_field_consistent": bool(
            torch.where(live, deg == store.degree, True).all()),
        "padding_clean": bool((~live[:, None] | valid | (edges == -1)).all()),
    }
    if tombstone is not None:
        row_live = live & ~tombstone
        out["no_dead_refs"] = bool(torch.where(
            row_live[:, None] & valid,
            ~tombstone[edges.clamp(min=0).long()], True).all())
    return out
