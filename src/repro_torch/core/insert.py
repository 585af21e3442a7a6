"""Structural update: wire new vertices into the graph (port of the
structural half of ``repro/core/insert.py``: ``structural_update``,
``_wire_reciprocal`` and ``_charge_writes``).

It is what the build wires every vertex with.  Position seeking, the wave
commits and the rest of the insert path come with the insert slice.

The reference wires a new vertex into its neighbors' rows one neighbor at
a time; each step reads and writes only that neighbor's row and
duplicates are skipped, so the port runs all neighbors of a vertex at
once.  Commits of different vertices that touch disjoint rows (their own
row and their neighbors') commute, so :func:`wire_block` commits a block
in rounds: a vertex goes one round after the last earlier vertex that
touched any of its rows, which keeps every row's writes in block order —
the result is the reference's serial scan, bit for bit.  Updates write
the store's tensors in place (the reference is functional): a build owns
its store, and copying the [N_max, R] edge table per vertex would
dominate it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core.iomodel import IOCounters, PAGE_BYTES
from repro_torch.core.layout import GraphStore, LayoutSpec, \
    relocate_edgelists

INF = 3.4e38


class StructuralResult(NamedTuple):
    store: GraphStore
    cache: cache_mod.CacheState | None
    counters: IOCounters | None
    n_wired: torch.Tensor       # reciprocal edges actually added
    modified: torch.Tensor      # [r] bool — which nbr edgelists changed


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
                     sym_tables: torch.Tensor) -> torch.Tensor:
    """Add each ``new_ids[i]`` into the edgelists of its neighbors
    ``nbrs[i]`` ([k, r]; the k vertices touch disjoint rows), in place,
    replacing the farthest entry (symmetric PQ distance) of a full row
    when the new vertex is closer.  Returns modified [k, r] bool."""
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
    d_row = torch.where(occupied, _sym_pairs(
        sym_tables, p_codes, codes[rows.clamp(min=0).long()]), -INF)
    worst = d_row.argmax(-1)
    d_new = _sym_pairs(sym_tables, p_codes,
                       codes[new_ids][:, None, None, :])[..., 0]
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
            sym_tables: torch.Tensor, first_pages: torch.Tensor):
    """Commit k vertices that touch disjoint rows, their fresh pages
    reserved at ``first_pages`` [k].  Returns (store, modified [k, r],
    pages_written [k], old pages [k, 1 + r] of the moved edgelists)."""
    ids = torch.tensor(new_ids, dtype=torch.long, device=nbrs.device)
    nbrs = torch.where(nbrs == ids[:, None], -1, nbrs).to(torch.int32)
    store.vectors[ids] = new_vecs.to(store.vectors.dtype)
    store.edges[ids] = nbrs
    store.degree[ids] = (nbrs >= 0).sum(1).to(store.degree.dtype)
    modified = _wire_reciprocal(store, nbrs, ids, codes, sym_tables)
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
                      cache: cache_mod.CacheState | None,
                      counters: IOCounters | None, new_vec: torch.Tensor,
                      nbrs: torch.Tensor, codes: torch.Tensor,
                      sym_tables: torch.Tensor,
                      new_id: int | None = None) -> StructuralResult:
    """② Commit a new vertex with neighbor list ``nbrs`` [R] at ``new_id``
    (default: append at ``store.count``).  ``cache`` may be None (the
    build's); otherwise dead old edge pages get the §8.2 eviction hint.
    ``counters`` None skips the write accounting."""
    new_id = store.count if new_id is None else int(new_id)
    first = _reserve(store, spec, 1)
    store, modified, written, old_pages = _commit(
        store, spec, [new_id], new_vec[None], nbrs[None], codes, sym_tables,
        first)
    store = dataclasses.replace(
        store, next_page=store.next_page + pages_per_insert(spec))
    modified, n_modified = modified[0], modified[0].sum()
    if counters is not None:
        counters = _charge_writes(counters, spec, n_modified, written[0])
    if cache is not None and old_pages is not None and \
            cache.policy != cache_mod.POLICIES["none"]:
        old = old_pages[0]
        dead = (old >= 0) & (store.page_live[old.clamp(min=0).long()] <= 0)
        cache = cache_mod.invalidate_pages(cache, old[dead].tolist())
    return StructuralResult(store, cache, counters, n_modified, modified)


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
