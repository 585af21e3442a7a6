"""Incremental maintenance (port of ``repro/core/maintenance.py``):
tombstone reclamation, edgelist repair, refine, defrag and the entrance
refresh.

Deletes only set a tombstone (paper §11): the slot is not reused, dead
edges keep absorbing traversal work, and out-of-place updates scatter
edgelists over ever fresher pages.  A consolidation pass undoes all
three, FreshDiskANN-style but incrementally:

① *repair* (:func:`repair_block`): every live→dead edge is spliced away —
   the vacated slot is refilled with the dead vertex's symmetric-PQ-
   nearest live neighbor not already in the row; surviving edges stay bit
   for bit.  Runs in bounded blocks (``EngineSpec.maint_block``).
①b *refine* (:func:`refine_block`): vertices inserted since the last pass
   are re-seeked and RobustPrune(α)-rewired to build quality.
② *reclaim* + ③ *defrag* (:func:`reclaim_and_defrag`): tombstoned slots
   no live edgelist references join the free list, and the surviving
   edgelists are re-packed id-contiguously from page 0
   (``layout.defrag_edgelists``), the cache invalidating what moved.
④ *entrance refresh* (:func:`refresh_entrance`,
   :func:`admit_entrance_pages`, :func:`refresh_default_entries`).

All I/O is charged to the counters the caller passes
(``EngineState.ctr_maint``), exactly as the reference charges it.

Batch-first: a repair block splices all its rows at once, serially over
the R slots of a row (a fill may not repeat an earlier fill of its row),
with no host sync; its eviction hints go to the cache on the device
(``cache.invalidate_where``).  A refine block re-seeks its vertices as one
frozen-cache ``disk_traverse`` wave (the ``adc_distance`` and
``pool_merge`` kernels), then applies them one after another in id order,
since that order decides which reciprocal edge wins; a vertex's own
neighbors are distinct, so their reciprocal checks are one step.  Exact
distances and RobustPrune are plain torch, as the reference's plain jnp.
Functions that change the store write its tensors in place (the engine
hands them a copy).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import cache as cache_mod
from repro_torch.core import entrance as ent_mod
from repro_torch.core import graph as graph_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core.iomodel import IOCounters, PAGE_BYTES, \
    merge_counters, sum_counters
from repro_torch.core.layout import GraphStore, LayoutSpec, \
    defrag_edgelists, relocate_edgelists

INF = 3.4e38
REFINE_ALPHA = 1.2      # RobustPrune diversity, as the Vamana build pass
_INT32_MAX = 2 ** 31 - 1


def _charge_list_writes(counters: IOCounters, spec: LayoutSpec, n_lists,
                        n_pages) -> IOCounters:
    """Charge writing ``n_lists`` edgelists over ``n_pages`` pages (ints or
    int64 tensors).  The packed layout drags each record's vector along;
    decoupled pages carry edgelists only."""
    edge_b = n_lists * spec.edgelist_bytes
    vec_b = n_lists * spec.vector_bytes if spec.kind == "packed" else 0
    pad = n_pages * PAGE_BYTES - edge_b - vec_b
    return dataclasses.replace(
        counters,
        write_requests=counters.write_requests + n_pages,
        edge_bytes_written=counters.edge_bytes_written + edge_b,
        wasted_vec_bytes_written=counters.wasted_vec_bytes_written + vec_b,
        pad_bytes_written=counters.pad_bytes_written + pad)


def _count_pages(p_max: int, pages: torch.Tensor, ok: torch.Tensor
                 ) -> torch.Tensor:
    """Distinct page ids among ``pages`` where ``ok`` (int64 scalar)."""
    hit = torch.zeros((p_max,), dtype=torch.int32, device=pages.device)
    hit.index_add_(0, torch.where(ok, pages.long(), 0).reshape(-1),
                   ok.to(torch.int32).reshape(-1))
    return (hit > 0).sum()


# ---------------------------------------------------------------------------
# ① Repair (one bounded block of the sweep)
# ---------------------------------------------------------------------------

def repair_block(store: GraphStore, codes: torch.Tensor,
                 sym_tables: torch.Tensor, tombstone: torch.Tensor,
                 cache: cache_mod.CacheState, counters: IOCounters,
                 start: int, *, spec: LayoutSpec, block: int):
    """Repair rows ``[start, start + block)``: in each live row with dead
    edges, every slot a tombstoned vertex holds is refilled with that
    dead vertex's symmetric-PQ-nearest live neighbor (first minimum) that
    is not the row's owner and not in the row already (earlier fills
    included); the row's other edges stay.  Rows without dead edges are
    not written, so blocks may run in any order.

    Charges one edge-page read per distinct page behind an examined live
    row or a spliced dead neighbor, and the layout's write cost for each
    repaired edgelist: the decoupled layout relocates them
    (``relocate_edgelists`` over the block's positions) and hints the
    cache to drop old pages left with no live edgelist (§8.2); the packed
    layout rewrites them in place.  Writes ``store`` in place.  Returns
    (store, cache, counters, n_repaired int64 tensor).
    """
    n_max, r = store.n_max, store.r
    dev = store.device
    nb = max(min(block, n_max - start), 0)       # rows past n_max: none
    rows = start + torch.arange(nb, device=dev)
    row_live = (rows < store.count) & ~tombstone[rows]
    row_edges = store.edges[rows]                               # [b, R]
    occ = row_edges.clamp(min=0).long()
    dead = (row_edges >= 0) & tombstone[occ] & row_live[:, None]
    need = row_live & dead.any(1)

    # the splice, serially over the R slots of all rows at once
    cur = torch.where(dead, -1, row_edges)
    cand_all = store.edges[occ]                                 # [b, R, R]
    ok_all = (cand_all >= 0) & ~tombstone[cand_all.clamp(min=0).long()] & \
        (cand_all != rows[:, None, None])
    for j in range(r):
        cand = cand_all[:, j]                                   # [b, R]
        ok = ok_all[:, j] & ~(cand[:, :, None] == cur[:, None, :]).any(-1)
        dd = torch.where(ok, pq_mod.sym_distance(
            sym_tables, codes[occ[:, j]], codes[cand.clamp(min=0).long()]),
            INF)
        best = dd.argmin(1, keepdim=True)
        fill = torch.where(dd.gather(1, best) < INF, cand.gather(1, best),
                           -1)[:, 0]
        cur[:, j] = torch.where(dead[:, j], fill, cur[:, j])
    store.edges[rows] = torch.where(need[:, None], cur, row_edges)
    store.degree[rows] = torch.where(
        need, (cur >= 0).sum(1).to(store.degree.dtype), store.degree[rows])

    # read charging: distinct pages behind examined rows + splice sources
    row_pages = store.edge_page[rows]
    dpages = store.edge_page[occ]
    n_read = _count_pages(
        store.p_max, torch.cat([row_pages, dpages.reshape(-1)]),
        torch.cat([row_live & (row_pages >= 0),
                   (dead & (dpages >= 0)).reshape(-1)]))
    counters = search_mod._charge_page_read(counters, spec, n_read)

    # write charging: repaired rows through the layout's update path
    n_mod = need.sum()
    if spec.kind == "decoupled":
        moved = torch.full((block,), -1, dtype=torch.int32, device=dev)
        moved[:nb] = torch.where(need, rows, -1).to(torch.int32)
        store, written = relocate_edgelists(store, moved, moved >= 0, spec)
        counters = _charge_list_writes(counters, spec, n_mod, written)
        # §8.2 eviction hints for old pages left with no live edgelist
        drop = need & (row_pages >= 0) & \
            (store.page_live[row_pages.clamp(min=0).long()] <= 0)
        mask = torch.zeros((store.p_max,), dtype=torch.int32, device=dev)
        mask.index_add_(0, torch.where(drop, row_pages.long(), 0),
                        drop.to(torch.int32))
        cache = cache_mod.invalidate_where(cache, mask > 0)
    else:
        counters = _charge_list_writes(counters, spec, n_mod,
                                       n_mod * spec.packed_pages_per_vertex)
    return store, cache, counters, n_mod


# ---------------------------------------------------------------------------
# ①b Refine (quality restoration for churn-inserted vertices)
# ---------------------------------------------------------------------------

def refine_block(store: GraphStore, codec: pq_mod.PQCodec,
                 codes: torch.Tensor, tombstone: torch.Tensor,
                 cache: cache_mod.CacheState, counters: IOCounters,
                 vids: list[int], entries: torch.Tensor, *,
                 spec: LayoutSpec, e_pos: int, beam_width: int,
                 max_hops: int, visited: str):
    """Re-wire the young vertices ``vids`` (ascending ids; the reference's
    block of 32 without its -1 padding, whose lanes charge and change
    nothing) to build quality: one frozen-cache traversal wave from
    ``entries`` [n_entry] with pool ``e_pos``, candidates = pool ∪ current
    edges (live, not the vertex, first occurrence of each id), exact
    distances, RobustPrune(α); then, one vertex after another, replace its
    edgelist, add it to each new neighbor's row (a free slot, else the
    farthest edge by exact distance if it is closer; skipped where it is
    present) and write the modified rows through the layout.

    Charges the traversal, one exact-vector read per surviving candidate
    (decoupled; a packed traversal dragged the vectors in) and the
    layout's write cost.  Writes ``store`` in place.  Returns (store,
    counters).
    """
    b = len(vids)
    if b == 0:
        return store, counters
    dev = store.device
    r = store.r
    vid = torch.tensor(vids, dtype=torch.long, device=dev)
    v = store.vectors[vid]                                       # [b, D]
    res = search_mod.disk_traverse(
        store, spec, pq_mod.adc_lut(codec, v), codes, cache,
        IOCounters.zeros((b,), dev), entries[None].expand(b, -1),
        pool_size=e_pos, beam_width=beam_width, max_hops=max_hops,
        visited=visited)
    cand = torch.cat([res.pool_ids, store.edges[vid]], 1)       # [b, C]
    safe = cand.clamp(min=0).long()
    keep = (cand >= 0) & (cand != vid[:, None]) & ~tombstone[safe]
    # sort-based dedupe (first occurrence wins)
    key = torch.where(keep, cand, _INT32_MAX)
    sk, si = torch.sort(key, dim=1, stable=True)
    first = torch.ones_like(keep)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    keep &= torch.zeros_like(keep).scatter(1, si, first)
    d = torch.where(keep, pq_mod.exact_l2(v, store.vectors[safe]), INF)
    new_rows = graph_mod.robust_prune(v, torch.where(keep, cand, -1), d,
                                      store.vectors, alpha=REFINE_ALPHA,
                                      r=r)
    ctr = res.counters
    if spec.kind == "decoupled":
        n_cand = keep.sum(1)
        vp = spec.vector_pages_per_read
        ctr = dataclasses.replace(
            ctr, read_requests=ctr.read_requests + n_cand * vp,
            useful_vec_bytes_read=ctr.useful_vec_bytes_read +
            n_cand * spec.vector_bytes,
            pad_bytes_read=ctr.pad_bytes_read +
            n_cand * (vp * PAGE_BYTES - spec.vector_bytes))
    counters = merge_counters(counters, sum_counters(ctr))

    # serial application, in id order
    for i in range(b):
        u = vid[i:i + 1]
        newr = new_rows[i]
        store.edges[u] = newr[None]
        store.degree[u] = (newr >= 0).sum().to(store.degree.dtype)
        p = newr.long()
        do = (p >= 0) & (p != u)
        sp = p.clamp(min=0)
        rows = store.edges[sp]                                   # [R, R]
        present = (rows == u[:, None]).any(1)
        occupied = rows >= 0
        free = (~occupied).to(torch.int8).argmax(1)
        has_free = ~occupied.all(1)
        pvec = store.vectors[sp]                                 # [R, D]
        d_row = torch.where(occupied, pq_mod.exact_l2(
            pvec, store.vectors[rows.clamp(min=0).long()]), -INF)
        worst = d_row.argmax(1, keepdim=True)
        d_v = ((pvec - store.vectors[u]) ** 2).sum(1)
        tgt = torch.where(has_free, free, worst[:, 0])
        modified = do & ~present & \
            (has_free | (d_v < d_row.gather(1, worst)[:, 0]))
        new_p = rows.scatter(1, tgt[:, None], u[:, None].expand(r, 1)
                             .to(rows.dtype))
        deg = store.degree[sp] + (modified & has_free).to(torch.int32)
        # slots not written rewrite the vertex's own row unchanged
        idx = torch.where(modified, sp, u)
        store.edges.index_put_((idx,), torch.where(modified[:, None], new_p,
                                                   newr[None]))
        store.degree.index_put_((idx,), torch.where(
            modified, deg, store.degree[u]))
        n_mod = modified.sum() + 1                  # + the vertex's own row
        if spec.kind == "decoupled":
            moved = torch.cat([u.to(torch.int32),
                               torch.where(modified, newr, -1)])
            store, pages = relocate_edgelists(store, moved, moved >= 0, spec)
        else:
            pages = n_mod * spec.packed_pages_per_vertex
        counters = _charge_list_writes(counters, spec, n_mod, pages)
    return store, counters


# ---------------------------------------------------------------------------
# ② + ③ Reclaim + defrag (cycle finalization)
# ---------------------------------------------------------------------------

def reclaim_and_defrag(store: GraphStore, tombstone: torch.Tensor,
                       free_list: torch.Tensor, free_count: int,
                       free_mask: torch.Tensor, cache: cache_mod.CacheState,
                       counters: IOCounters, *, spec: LayoutSpec):
    """Finalize a cycle after the repair sweep: every tombstoned slot in
    the prefix that is not reclaimed yet and that no live edgelist
    references (after a full sweep, all of them) is appended to the free
    list in id order; every reclaimed row is cleared; the holders' pages
    are re-packed from page 0; every page whose contents changed, or that
    holds no edgelist now, leaves the cache.  Charges the defrag's stream
    read (the holders' distinct pages) and write.  Writes ``free_list``
    and ``free_mask`` in place.  Returns (store, free_count, cache,
    counters).
    """
    n_max = store.n_max
    dev = store.device
    idx = torch.arange(n_max, device=dev)
    in_prefix = idx < store.count
    row_live = in_prefix & ~tombstone
    ref_ok = row_live[:, None] & (store.edges >= 0)
    referenced = torch.zeros((n_max,), dtype=torch.int32, device=dev)
    referenced.index_add_(0, torch.where(ref_ok, store.edges, 0).long()
                          .reshape(-1), ref_ok.to(torch.int32).reshape(-1))
    new_free = in_prefix & tombstone & ~free_mask & (referenced == 0)
    pos = torch.where(new_free, free_count + torch.cumsum(
        new_free.to(torch.int64), 0) - 1, n_max)
    spill = torch.cat([free_list, free_list[:1]])        # n_max: dropped
    spill[pos] = idx.to(free_list.dtype)
    free_list.copy_(spill[:n_max])
    n_new = int(new_free.sum())
    free_mask |= new_free
    store.edges.masked_fill_(free_mask[:, None], -1)
    store.degree.masked_fill_(free_mask, 0)

    holders = in_prefix & ~free_mask
    n_pre = _count_pages(store.p_max, store.edge_page,
                         holders & (store.edge_page >= 0))
    n_hold = int(holders.sum())
    store, changed, n_pages = defrag_edgelists(store, holders, spec)
    counters = search_mod._charge_page_read(counters, spec, n_pre)
    counters = _charge_list_writes(counters, spec, n_hold, n_pages)
    # pages whose contents moved, and pages the rebuilt map left empty
    # (repair may drain a page without tripping its own hint)
    cache = cache_mod.invalidate_where(cache, changed |
                                       (store.page_live <= 0))
    return store, free_count + n_new, cache, counters


# ---------------------------------------------------------------------------
# ④ Entrance refresh (the engine orchestrates it on the host)
# ---------------------------------------------------------------------------

def refresh_entrance(key: torch.Tensor, codes: torch.Tensor,
                     sym_tables: torch.Tensor, old_ent: ent_mod.EntranceGraph,
                     tombstone: torch.Tensor, live_ids: np.ndarray, *,
                     sample_frac: float, r_ent: int, n_max: int,
                     top_up: bool = True) -> ent_mod.EntranceGraph:
    """Refresh the entrance over the live set ``live_ids`` (ascending),
    keeping the surviving members and their wiring.  ``top_up`` (static
    entrances): the head count dead members vacated is topped back up with
    live samples drawn without replacement (``add_member`` each); a
    dynamic entrance regrows through Algorithm 2 as inserts flow.  When
    the slot high-water mark would come within ``r_ent`` of ``c_max``,
    the members are re-linked from scratch (``link_members``), which
    compacts the holes.  Returns a new graph; ``old_ent`` is untouched."""
    c_max = old_ent.c_max
    n_live = int(live_ids.shape[0])
    target = max(min(int(n_live * sample_frac), c_max), min(n_live, 2))
    old = old_ent.ids.cpu().numpy()
    old = old[old >= 0]
    survivors = old[~tombstone.cpu().numpy()[old]][:target]
    need = (target - len(survivors)) if top_up else 0
    fresh = np.zeros((0,), np.int32)
    if need > 0:
        pool = np.setdiff1d(live_ids, survivors)
        pick = jr.choice(key, pool.shape[0], (min(need, pool.shape[0]),),
                         replace=False)
        fresh = pool[pick.numpy()]
    members = np.concatenate([survivors, fresh]).astype(np.int32)
    dev = codes.device
    if old_ent.count + len(fresh) + r_ent > c_max and len(members) >= 2:
        return ent_mod.link_members(torch.from_numpy(members).to(dev), codes,
                                    sym_tables, c_max=c_max, r_ent=r_ent,
                                    n_max=n_max)
    ent = dataclasses.replace(old_ent, ids=old_ent.ids.clone(),
                              edges=old_ent.edges.clone(),
                              main_to_ent=old_ent.main_to_ent.clone())
    for vid in fresh.tolist():
        ent = ent_mod.add_member(ent, vid, codes, sym_tables)
    return ent


def admit_entrance_pages(cache: cache_mod.CacheState, store: GraphStore,
                         ent: ent_mod.EntranceGraph) -> cache_mod.CacheState:
    """Priority-admit each live member's edgelist page into the frozen
    region, in slot order (§7's entrance-aware hint; NAVIS policy only)."""
    if cache.policy != cache_mod.POLICIES["navis"]:
        return cache
    ids = ent.ids
    pages = torch.where(ids >= 0, store.edge_page[ids.clamp(min=0).long()],
                        -1)
    handle = cache_mod.open(cache)
    handle.priority_admit(pages)          # -1 entries are skipped
    return handle.state()


def refresh_default_entries(key: torch.Tensor, vectors: torch.Tensor,
                            live_ids: torch.Tensor, n_entry: int
                            ) -> torch.Tensor:
    """Fallback entry points over the live set: the live medoid first (as
    the build), then ``n_entry - 1`` random live picks."""
    live_vecs = vectors[live_ids.long()]
    c = live_vecs.mean(0)
    med = live_ids[((live_vecs - c) ** 2).sum(1).argmin()]
    rest = live_ids[jr.randint(key, (n_entry - 1,), 0, live_ids.shape[0])
                    .to(live_ids.device)]
    return torch.cat([med[None], rest]).to(torch.int32)
