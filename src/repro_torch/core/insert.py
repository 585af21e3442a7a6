"""In-place insertion: ① position seeking -> ② structural update (port of
``repro/core/insert.py``).

Position seeking is a full graph traversal with a large explored pool
(|E_pos| ≫ |E_search|) whose only job is to surface ~R adequate neighbors
for the new vertex; it reuses :func:`search.disk_traverse` and reranks
with CASR at ``s_pos`` or, in the baselines, with the full rerank (the
whole pool by exact distance, then the first R).  :func:`position_seek`
runs a wave of seeks batch-first against a frozen snapshot
(``insert_many``'s phase ①) or one seek threaded through a cache handle
(:func:`cache.open`: the sequential insert).

The structural update wires the new vertex to its neighbors, adds
reciprocal edges (pruning the farthest edge by symmetric-PQ distance when
a neighbor is at degree R), moves the modified edgelists onto fresh edge
pages and charges the writes.  A wave commit first re-validates its
snapshot picks (:func:`revalidate_neighbors`) and pays an RMW re-read for
every neighbor edge page an earlier commit of the wave dirtied
(:func:`charge_rmw_rereads`, :func:`mark_dirty_pages`).

The reference wires a new vertex into its neighbors' rows one neighbor at
a time; each step reads and writes only that neighbor's row and
duplicates are skipped, so the port runs all neighbors of a vertex at
once.  Commits of different vertices that touch disjoint rows (their own
row and their neighbors') commute, so :func:`wire_block` commits a build
block in rounds: a vertex goes one round after the last earlier vertex
that touched any of its rows, which keeps every row's writes in block
order — the result is the reference's serial scan, bit for bit.  The
build sums symmetric distances in torch's order (a block's per-neighbor
ADC tables would take gigabytes); a runtime commit (:func:`commit_insert`)
sums them in subspace order through the ADC kernel, as the reference
does.  Updates write the store's tensors in place: a build owns its
store, and an engine operation copies the state once before it mutates
it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import casr as casr_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core import visited as visited_mod
from repro_torch.core.iomodel import IOCounters, PAGE_BYTES
from repro_torch.core.layout import GraphStore, LayoutSpec, \
    relocate_edgelists

INF = 3.4e38


# ---------------------------------------------------------------------------
# Neighbor selection (paper §5.2-5.3)
# ---------------------------------------------------------------------------

def select_neighbors(pool_ids: torch.Tensor, casr_res, r: int
                     ) -> torch.Tensor:
    """Order each lane's pool [B, P] for wiring: the CASR-loaded part by
    exact distance first, then the unloaded rest in PQ order.  Returns
    [B, r] ids (-1 padded).

    The key is the reference's, in float32: ``1e30 + position`` rounds to
    1e30 for every unloaded slot, so their PQ order comes from the stable
    sort, as it does there."""
    p = pool_ids.shape[1]
    valid = pool_ids >= 0
    ar = torch.arange(p, dtype=torch.float32, device=pool_ids.device)
    key = torch.where(casr_res.loaded & valid, casr_res.exact_d,
                      torch.where(valid, 1e30 + ar, INF))
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.where(valid.gather(1, order), pool_ids.gather(1, order),
                       -1)[:, :r]


class StructuralResult(NamedTuple):
    store: GraphStore
    cache: cache_mod.Handle | None
    counters: IOCounters | None
    n_wired: torch.Tensor       # reciprocal edges actually added
    modified: torch.Tensor      # [r] bool — which nbr edgelists changed
    # old edge pages left with no live slot (the §8.2 eviction hints), in
    # the order the reference applies them, -1 elsewhere ([1 + r]; None
    # for the packed layout)
    dead_pages: torch.Tensor | None = None


def _sym_pairs(tables: torch.Tensor, code_a: torch.Tensor,
               code_b: torch.Tensor) -> torch.Tensor:
    """Symmetric PQ distances of ``code_a`` [..., M] to ``code_b``
    [..., C, M] -> [..., C], gathered straight from the tables (an ADC
    table per neighbor would copy M * 256 floats for every row).  The sum
    over subspaces runs in torch's order, not the reference's."""
    m = tables.shape[0]
    off = torch.arange(m, device=tables.device) * (256 * 256)
    idx = off + code_a.long()[..., None, :] * 256 + code_b.long()
    return tables.reshape(-1)[idx].sum(-1)


def _wire_reciprocal(store: GraphStore, nbrs: torch.Tensor,
                     new_ids: torch.Tensor, codes: torch.Tensor,
                     sym_tables: torch.Tensor,
                     in_order: bool = False) -> torch.Tensor:
    """Add each ``new_ids[i]`` into the edgelists of its neighbors
    ``nbrs[i]`` ([k, r]; the k vertices touch disjoint rows), in place,
    replacing the farthest entry (symmetric PQ distance) of a full row
    when the new vertex is closer.  ``in_order`` sums the distances over
    subspaces in order through the ADC kernel (one [M, 256] table per
    neighbor), as the reference does; otherwise in torch's order.
    Returns modified [k, r] bool."""
    k, r = nbrs.shape
    p = nbrs.long()
    ar = torch.arange(r, device=p.device)
    dup = ((p[:, :, None] == p[:, None, :]) &
           (ar[None, None, :] < ar[None, :, None])).any(2)
    do = (p >= 0) & (p != new_ids[:, None]) & ~dup
    safe = p.clamp(min=0)
    rows = store.edges[safe]                                   # [k, r, R]
    occupied = rows >= 0
    free = (~occupied).to(torch.int8).argmax(-1)        # first empty slot
    has_free = ~occupied.all(-1)
    p_codes = codes[safe]                                      # [k, r, M]
    row_codes = codes[rows.clamp(min=0).long()]             # [k, r, R, M]
    if in_order:
        m = codes.shape[1]
        targets = torch.cat([row_codes, codes[new_ids][:, None, None, :]
                             .expand(k, r, 1, m)], 2)
        d = pq_mod.sym_distance(sym_tables, p_codes.reshape(k * r, m),
                                targets.reshape(k * r, -1, m)
                                ).reshape(k, r, -1)
        d_row, d_new = d[..., :-1], d[..., -1]
    else:
        d_row = _sym_pairs(sym_tables, p_codes, row_codes)
        d_new = _sym_pairs(sym_tables, p_codes,
                           codes[new_ids][:, None, None, :])[..., 0]
    d_row = torch.where(occupied, d_row, -INF)
    worst = d_row.argmax(-1)
    tgt = torch.where(has_free, free, worst)
    write = has_free | (d_new < d_row.gather(-1, worst[..., None])[..., 0])
    modified = do & write
    new_rows = rows.scatter(-1, tgt[..., None], new_ids[:, None, None].expand(
        k, r, 1).to(rows.dtype))
    new_deg = store.degree[safe] + (modified & has_free).to(torch.int32)
    # slots not written rewrite their vertex's own row unchanged, so the
    # scatter's duplicate indices carry equal values
    idx = torch.where(modified, safe, new_ids[:, None]).reshape(-1)
    own_row, own_deg = store.edges[new_ids], store.degree[new_ids]
    store.edges.index_put_((idx,), torch.where(
        modified[..., None], new_rows, own_row[:, None]).reshape(k * r, -1))
    store.degree.index_put_((idx,), torch.where(
        modified, new_deg, own_deg[:, None]).reshape(-1))
    return modified


def _charge_writes(counters: IOCounters, spec: LayoutSpec,
                   n_modified_nbrs: torch.Tensor,
                   edge_pages_written: torch.Tensor) -> IOCounters:
    """Write-side accounting for one insertion under either layout."""
    el = spec.edgelist_bytes
    vb = spec.vector_bytes
    n_mod = n_modified_nbrs.to(torch.int64)
    if spec.kind == "packed":
        ppv = spec.packed_pages_per_vertex
        n_pages = (1 + n_mod) * ppv
        edge_b = (1 + n_mod) * el
        wasted_b = n_mod * vb
        pad = n_pages * PAGE_BYTES - edge_b - vb - wasted_b
        return dataclasses.replace(
            counters,
            write_requests=counters.write_requests + n_pages,
            edge_bytes_written=counters.edge_bytes_written + edge_b,
            vec_bytes_written=counters.vec_bytes_written + vb,
            wasted_vec_bytes_written=counters.wasted_vec_bytes_written +
            wasted_b,
            pad_bytes_written=counters.pad_bytes_written + pad)
    vec_pages = spec.vector_pages_per_read
    pages = edge_pages_written.to(torch.int64)
    edge_b = (1 + n_mod) * el
    return dataclasses.replace(
        counters,
        write_requests=counters.write_requests + pages + vec_pages,
        edge_bytes_written=counters.edge_bytes_written + edge_b,
        vec_bytes_written=counters.vec_bytes_written + vb,
        pad_bytes_written=counters.pad_bytes_written +
        pages * PAGE_BYTES - edge_b + (vec_pages * PAGE_BYTES - vb))


def pages_per_insert(spec: LayoutSpec) -> int:
    """Fresh pages one insertion takes from the bump allocator."""
    if spec.kind == "packed":
        return 1
    return -(-(1 + spec.r) // spec.edgelists_per_page)


def _commit(store: GraphStore, spec: LayoutSpec, new_ids: list[int],
            new_vecs: torch.Tensor, nbrs: torch.Tensor, codes: torch.Tensor,
            sym_tables: torch.Tensor, first_pages: torch.Tensor,
            in_order: bool = False):
    """Commit k vertices that touch disjoint rows, their fresh pages
    reserved at ``first_pages`` [k].  Returns (store, modified [k, r],
    pages_written [k], old pages [k, 1 + r] of the moved edgelists)."""
    # one id: a fill, not a host-to-device copy (which would wait for the
    # device), so a wave's commits queue without a sync
    ids = (torch.full((1,), new_ids[0], dtype=torch.long,
                      device=nbrs.device) if len(new_ids) == 1 else
           torch.tensor(new_ids, dtype=torch.long, device=nbrs.device))
    nbrs = torch.where(nbrs == ids[:, None], -1, nbrs).to(torch.int32)
    store.vectors[ids] = new_vecs.to(store.vectors.dtype)
    store.edges[ids] = nbrs
    store.degree[ids] = (nbrs >= 0).sum(1).to(store.degree.dtype)
    modified = _wire_reciprocal(store, nbrs, ids, codes, sym_tables,
                                in_order)
    store = dataclasses.replace(store, count=max(store.count,
                                                 max(new_ids) + 1))
    if spec.kind == "packed":
        # in-place page rewrites; each new vertex gets a fresh page group
        store.edge_page[ids] = first_pages.to(torch.int32)
        store.page_live.index_add_(0, first_pages.long(),
                                   torch.ones_like(first_pages,
                                                   dtype=torch.int32))
        zero = torch.zeros((len(new_ids),), dtype=torch.int64,
                           device=nbrs.device)
        return store, modified, zero, None
    moved = torch.cat([ids[:, None].to(torch.int32),
                       torch.where(modified, nbrs, -1)], dim=1)
    valid = moved >= 0
    old_pages = torch.where(valid,
                            store.edge_page[moved.clamp(min=0).long()], -1)
    store, written = relocate_edgelists(store, moved, valid, spec,
                                        first_pages)
    return store, modified, written, old_pages


def _reserve(store: GraphStore, spec: LayoutSpec, k: int) -> torch.Tensor:
    """Take k insertions' fresh pages from the bump allocator (raises past
    the page budget); returns each insertion's first page [k]."""
    n_new = pages_per_insert(spec)
    base = store.next_page
    if base + k * n_new > store.p_max:
        raise RuntimeError(f"edge page {base + k * n_new - 1} is past the "
                           f"page budget ({store.p_max} pages)")
    return base + torch.arange(k, device=store.device) * n_new


def structural_update(store: GraphStore, spec: LayoutSpec,
                      cache: cache_mod.Handle | None,
                      counters: IOCounters | None, new_vec: torch.Tensor,
                      nbrs: torch.Tensor, codes: torch.Tensor,
                      sym_tables: torch.Tensor,
                      new_id: int | None = None, *,
                      in_order: bool = False) -> StructuralResult:
    """② Commit a new vertex with neighbor list ``nbrs`` [R] at ``new_id``
    (default: append at ``store.count``; a smaller id re-occupies a
    reclaimed slot and ``count`` only grows past it).  Old edge pages left
    with no live slot get the §8.2 eviction hint: applied to ``cache`` in
    place when given, and handed back in ``dead_pages`` either way, so a
    caller with ``cache`` None can apply them later in commit order.
    ``counters`` None skips the write accounting; ``in_order`` as in
    :func:`_wire_reciprocal`."""
    new_id = store.count if new_id is None else int(new_id)
    first = _reserve(store, spec, 1)
    store, modified, written, old_pages = _commit(
        store, spec, [new_id], new_vec[None], nbrs[None], codes, sym_tables,
        first, in_order)
    store = dataclasses.replace(
        store, next_page=store.next_page + pages_per_insert(spec))
    modified, n_modified = modified[0], modified[0].sum()
    if counters is not None:
        counters = _charge_writes(counters, spec, n_modified, written[0])
    dead_pages = None
    if old_pages is not None:
        old = old_pages[0]
        dead_pages = torch.where(
            (old >= 0) & (store.page_live[old.clamp(min=0).long()] <= 0),
            old, -1)
        if cache is not None and \
                cache.policy != cache_mod.POLICIES["none"]:
            cache.invalidate(dead_pages)        # -1 entries are skipped
    return StructuralResult(store, cache, counters, n_modified, modified,
                            dead_pages)


def commit_rounds(new_ids: list[int], nbrs: list[list[int]]) -> list[int]:
    """Round of each commit of a block: one after the last earlier commit
    that touched any of its rows (its own and its neighbors')."""
    last: dict[int, int] = {}
    rounds = []
    for vid, row in zip(new_ids, nbrs):
        touched = {vid, *(p for p in row if p >= 0)}
        rd = 1 + max((last.get(x, -1) for x in touched), default=-1)
        for x in touched:
            last[x] = rd
        rounds.append(rd)
    return rounds


def wire_block(store: GraphStore, spec: LayoutSpec, vecs: torch.Tensor,
               nbrs: torch.Tensor, codes: torch.Tensor,
               sym_tables: torch.Tensor) -> GraphStore:
    """Append a block of vertices ``vecs`` [b, D] with neighbor lists
    ``nbrs`` [b, R], exactly as b :func:`structural_update` calls in
    order would (no cache, no counters: the build's commit)."""
    b = vecs.shape[0]
    count0 = store.count
    new_ids = list(range(count0, count0 + b))
    first = _reserve(store, spec, b)
    rounds = commit_rounds(new_ids, nbrs.tolist())
    by_round: dict[int, list[int]] = {}
    for i, rd in enumerate(rounds):
        by_round.setdefault(rd, []).append(i)
    for rd in sorted(by_round):
        sel = by_round[rd]
        idx = torch.tensor(sel, device=vecs.device)
        store, _, _, _ = _commit(store, spec, [new_ids[i] for i in sel],
                                 vecs[idx], nbrs[idx], codes, sym_tables,
                                 first[idx])
    return dataclasses.replace(
        store, next_page=store.next_page + b * pages_per_insert(spec))


# ---------------------------------------------------------------------------
# Conflict-aware wave commits (batch-parallel insert fan-out)
# ---------------------------------------------------------------------------
#
# ``insert_many`` seeks a whole wave against one frozen snapshot, then
# commits serially.  A late commit sees a graph the earlier commits have
# changed, so its snapshot picks are re-validated, and every neighbor edge
# page a prior commit dirtied is re-read before the RMW: the copy its own
# traversal read is stale.

def revalidate_neighbors(nbrs: torch.Tensor, new_id: int,
                         new_code: torch.Tensor, codes: torch.Tensor,
                         sym_tables: torch.Tensor,
                         tombstone: torch.Tensor) -> torch.Tensor:
    """Re-check a snapshot-selected neighbor list [r] at commit time: drop
    self-references, repeats and now-tombstoned picks, then order the
    survivors by symmetric-PQ distance to ``new_code`` [M] (stable; codes
    are in host memory, so this costs no storage I/O).  Returns [r] ids,
    -1 padded at the tail."""
    r = nbrs.shape[0]
    safe = nbrs.clamp(min=0).long()
    ar = torch.arange(r, device=nbrs.device)
    dup = ((nbrs[:, None] == nbrs[None, :]) & (nbrs[None, :] >= 0) &
           (ar[None, :] < ar[:, None])).any(1)
    valid = (nbrs >= 0) & (nbrs != new_id) & ~tombstone[safe] & ~dup
    d = pq_mod.sym_distance(sym_tables, new_code[None], codes[safe][None])[0]
    order = torch.sort(torch.where(valid, d, INF), stable=True).indices
    return torch.where(valid[order], nbrs[order], -1)


def charge_rmw_rereads(counters: IOCounters, spec: LayoutSpec,
                       store: GraphStore, nbrs: torch.Tensor,
                       dirty_pages: torch.Tensor
                       ) -> tuple[IOCounters, torch.Tensor]:
    """Charge one edge-page read per distinct neighbor page [r] that an
    earlier commit of the wave dirtied.  Returns (counters, n_reread)."""
    r = nbrs.shape[0]
    valid = nbrs >= 0
    pages = torch.where(valid, store.edge_page[nbrs.clamp(min=0).long()],
                        -1)
    ar = torch.arange(r, device=nbrs.device)
    dup = ((pages[:, None] == pages[None, :]) & (pages[None, :] >= 0) &
           (ar[None, :] < ar[:, None])).any(1)
    hit = valid & (pages >= 0) & dirty_pages[pages.clamp(min=0).long()] & \
        ~dup
    n = hit.sum()
    return search_mod._charge_page_read(counters, spec, n), n


def mark_dirty_pages(dirty_pages: torch.Tensor, store: GraphStore,
                     new_id: int, nbrs: torch.Tensor,
                     modified: torch.Tensor) -> torch.Tensor:
    """Record, in place, the pages a commit wrote (post-commit ``store``):
    the new vertex's page and each rewritten neighbor edgelist's page."""
    touched = torch.cat([torch.full((1,), new_id, dtype=torch.int32,
                                    device=nbrs.device),
                         torch.where(modified, nbrs, -1).to(torch.int32)])
    pages = store.edge_page[touched.clamp(min=0).long()]
    mark = (touched >= 0) & (pages >= 0)
    # a max-scatter of 0 leaves the unmarked slots' targets as they are
    dirty_pages.view(torch.uint8).scatter_reduce_(
        0, pages.clamp(min=0).long(), mark.to(torch.uint8), "amax")
    return dirty_pages


# ---------------------------------------------------------------------------
# Full insertion (position seek + rerank + wire)
# ---------------------------------------------------------------------------

class SeekResult(NamedTuple):
    """Phase-① output, one lane per insert: what a commit needs, plus the
    traversal's I/O evidence (trace, frozen mode) for the cache replay."""
    nbrs: torch.Tensor            # [B, R] selected neighbors (-1 padded)
    pool_ids: torch.Tensor        # [B, e_pos] E_pos (PQ-sorted, masked)
    hops: torch.Tensor            # [B] int32
    rerank_rounds: torch.Tensor   # [B] int32
    counters: IOCounters          # [B]
    page_seen: visited_mod.VisitedSet | torch.Tensor
    trace: torch.Tensor | None = None     # frozen mode only
    trace_n: torch.Tensor | None = None


def position_seek(store: GraphStore, spec: LayoutSpec,
                  codec: pq_mod.PQCodec, codes: torch.Tensor,
                  cache: cache_mod.CacheState | cache_mod.Handle,
                  counters: IOCounters, new_vecs: torch.Tensor,
                  entry_ids: torch.Tensor, *, e_pos: int, k: int, s: int,
                  rerank: str = "casr", beam_width: int = 4,
                  max_hops: int = 512,
                  tombstone: torch.Tensor | None = None, page_seen=None,
                  visited: str = "hash") -> SeekResult:
    """① Position seeking for ``new_vecs`` [B, D]: traverse with a pool of
    ``e_pos``, mask tombstoned ids out of it, rerank it and select the
    neighbors.  ``rerank="casr"`` reranks in groups of ``s`` (one
    ``casr_rerank`` launch for the wave on the card) and orders the pool
    by :func:`select_neighbors`; ``"full"`` reranks the whole pool (one
    ``rerank_l2_rows`` launch) and takes its first R, in one rerank
    round.  No structural mutation.  A snapshot ``cache`` runs the wave
    frozen (each lane records its trace); a cache handle runs one seek
    threaded through it (the sequential insert).  ``page_seen``
    and ``visited`` go to the traversal."""
    lut = pq_mod.adc_lut(codec, new_vecs)
    res = search_mod.disk_traverse(
        store, spec, lut, codes, cache, counters, entry_ids,
        pool_size=e_pos, beam_width=beam_width, max_hops=max_hops,
        page_seen=page_seen, visited=visited)
    counters = res.counters
    pool_ids = res.pool_ids
    if tombstone is not None:
        dead = (pool_ids >= 0) & tombstone[pool_ids.clamp(min=0).long()]
        counters = dataclasses.replace(
            counters, tombstone_skips=counters.tombstone_skips + dead.sum(1))
        pool_ids = torch.where(dead, -1, pool_ids)
    if rerank == "casr":
        cres = casr_mod.casr_rerank(store, spec, new_vecs, pool_ids,
                                    counters, k=k, s=s)
        counters = cres.counters
        nbrs = select_neighbors(pool_ids, cres, store.r)
        rounds = cres.rerank_rounds
    else:
        ids, _, _, counters = search_mod.full_rerank(
            store, spec, new_vecs, res._replace(pool_ids=pool_ids),
            counters, k=pool_ids.shape[1])
        nbrs = ids[:, :store.r]      # the reference's full_pool_neighbors
        rounds = torch.ones_like(res.hops)
    return SeekResult(nbrs=nbrs, pool_ids=pool_ids, hops=res.hops,
                      rerank_rounds=rounds, counters=counters,
                      page_seen=res.page_seen, trace=res.trace,
                      trace_n=res.trace_n)


def commit_insert(store: GraphStore, spec: LayoutSpec,
                  cache: cache_mod.Handle | None, counters: IOCounters,
                  new_vec: torch.Tensor, nbrs: torch.Tensor,
                  codes: torch.Tensor, sym_tables: torch.Tensor,
                  new_id: int) -> StructuralResult:
    """② The runtime commit of one insertion: :func:`structural_update`
    with the symmetric distances summed in subspace order, as the
    reference sums them.  With ``cache`` None the eviction hints come
    back in ``dead_pages`` only (a wave applies them after its commits,
    which is the same order: no commit reads the cache)."""
    return structural_update(store, spec, cache, counters, new_vec, nbrs,
                             codes, sym_tables, new_id, in_order=True)


class InsertResult(NamedTuple):
    store: GraphStore
    counters: IOCounters          # scalar: the seek's and the commit's
    new_id: int
    pool_ids: torch.Tensor        # [e_pos] E_pos, reused by NAVIS-update
    hops: torch.Tensor            # scalar int32
    rerank_rounds: torch.Tensor   # scalar int32
    # this insert's pages: one lane's visited set, or a raw [P_max] map
    # (seeded raw, or bitmap mode)
    page_seen: visited_mod.VisitedSet | torch.Tensor


def insert_vertex(store: GraphStore, spec: LayoutSpec,
                  codec: pq_mod.PQCodec, codes: torch.Tensor,
                  sym_tables: torch.Tensor, cache: cache_mod.Handle,
                  counters: IOCounters, new_vec: torch.Tensor,
                  entry_ids: torch.Tensor, *, e_pos: int, k: int, s: int,
                  rerank: str = "casr", beam_width: int = 4,
                  max_hops: int = 512,
                  tombstone: torch.Tensor | None = None,
                  page_seen: torch.Tensor | None = None,
                  visited: str = "hash",
                  new_id: int | None = None) -> InsertResult:
    """One sequential in-place insertion of ``new_vec`` [D] from
    ``entry_ids`` [n_entry]: a threaded seek through ``cache`` (advanced
    in place, the commit's eviction hints included), then the commit at
    ``new_id`` (default ``store.count``).  The caller writes the new
    vector's code into ``codes`` first; ``counters`` is a scalar tally.
    ``page_seen`` [P_max] bool seeds the seek's page buffer (a merge
    shares one across its inserts); the pages it ends with come back."""
    seek = position_seek(
        store, spec, codec, codes, cache, counters.map(lambda x: x[None]),
        new_vec[None], entry_ids[None], e_pos=e_pos, k=k, s=s,
        rerank=rerank, beam_width=beam_width, max_hops=max_hops,
        tombstone=tombstone,
        page_seen=None if page_seen is None else page_seen[None],
        visited=visited)
    nid = store.count if new_id is None else int(new_id)
    sres = commit_insert(store, spec, cache, seek.counters.map(
        lambda x: x[0]), new_vec, seek.nbrs[0], codes, sym_tables, nid)
    ps = seek.page_seen             # lane 0 of a raw map or a visited set
    ps = (ps[0] if isinstance(ps, torch.Tensor) else type(ps)(
        *[getattr(ps, f.name)[0] for f in dataclasses.fields(ps)]))
    return InsertResult(
        store=sres.store, counters=sres.counters, new_id=nid,
        pool_ids=seek.pool_ids[0], hops=seek.hops[0],
        rerank_rounds=seek.rerank_rounds[0], page_seen=ps)
