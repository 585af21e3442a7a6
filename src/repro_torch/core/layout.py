"""On-"disk" storage layouts (port of ``repro/core/layout.py``).

Packed layout: one page group per vertex holding ``[vector][degree]
[edgelist]``.  Locality-driven decoupling (NAVIS §5.1): an edgelist file
packing several edgelists per 4 KiB page, a vector file, and an
indirection table vertex -> edge page.  Edge updates are out-of-place:
modified edgelists are gathered onto fresh pages and the pointers flipped.

Page budget.  The reference sizes the edge-page space as ``2 * n_max``,
but every decoupled insert bump-allocates ``ceil((1 + r) / per)`` fresh
pages, so at ``r = 48`` (3 pages per insert) a build runs past the end
and JAX silently clamps the gathers and drops the scatters.  The port
sizes the space for the worst case (:func:`page_budget`) and raises on
any page id past it instead of clamping.

Updates write the store's tensors in place (a build or a commit owns the
store it mutates); the host integers ``count`` and ``next_page`` come
back in a new :class:`GraphStore` around the same tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.iomodel import PAGE_BYTES
from repro_torch.device import resolve_device


@dataclasses.dataclass
class GraphStore:
    """The proximity graph + vectors + layout bookkeeping.

    edges [N_max, R] int32 (-1 padded), degree [N_max] int32, vectors
    [N_max, D] float32, edge_page [N_max] int32 (the indirection table),
    page_live [P_max] int32 (live edgelists per page).  ``count`` (live
    vertices) and ``next_page`` (bump allocator) are host integers: every
    change to them is known on the host, so reading them costs no sync.
    """

    edges: torch.Tensor
    degree: torch.Tensor
    vectors: torch.Tensor
    count: int
    edge_page: torch.Tensor
    page_live: torch.Tensor
    next_page: int

    @property
    def n_max(self) -> int:
        return self.edges.shape[0]

    @property
    def r(self) -> int:
        return self.edges.shape[1]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def p_max(self) -> int:
        return self.page_live.shape[0]

    @property
    def device(self) -> torch.device:
        return self.edges.device


@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """Static layout geometry (bytes per record, records per page)."""

    kind: str                  # "packed" | "decoupled"
    dim: int
    r: int
    vec_dtype_bytes: int = 4

    @property
    def vector_bytes(self) -> int:
        return self.dim * self.vec_dtype_bytes

    @property
    def edgelist_bytes(self) -> int:
        return 8 + 4 * self.r          # id + degree + edge ids

    @property
    def packed_record_bytes(self) -> int:
        return self.vector_bytes + self.edgelist_bytes

    @property
    def packed_pages_per_vertex(self) -> int:
        return -(-self.packed_record_bytes // PAGE_BYTES)

    @property
    def packed_per_page(self) -> int:
        return max(PAGE_BYTES // self.packed_record_bytes, 1)

    @property
    def edgelists_per_page(self) -> int:
        return max(PAGE_BYTES // self.edgelist_bytes, 1)

    @property
    def vector_pages_per_read(self) -> int:
        return -(-self.vector_bytes // PAGE_BYTES)

    def read_pad_bytes(self, kind_pages: int, payload: int) -> int:
        return kind_pages * PAGE_BYTES - payload

    @property
    def per_page(self) -> int:
        return (self.packed_per_page if self.kind == "packed"
                else self.edgelists_per_page)


def page_budget(n_max: int, r: int) -> int:
    """Edge pages a store of ``n_max`` vertices can ever need: the initial
    placement plus ``ceil((1 + r) / per)`` fresh pages for every insert
    (decoupled worst case; the packed layout takes one page per insert,
    which ``2 * n_max`` already covers)."""
    per = LayoutSpec("decoupled", 1, r).edgelists_per_page
    return max(2 * n_max, -(-n_max // per) + n_max * -(-(1 + r) // per))


def empty_store(n_max: int, dim: int, r: int, device=None) -> GraphStore:
    device = resolve_device(device)
    p_max = page_budget(n_max, r)
    return GraphStore(
        edges=torch.full((n_max, r), -1, dtype=torch.int32, device=device),
        degree=torch.zeros((n_max,), dtype=torch.int32, device=device),
        vectors=torch.zeros((n_max, dim), dtype=torch.float32, device=device),
        count=0,
        edge_page=torch.full((n_max,), -1, dtype=torch.int32, device=device),
        page_live=torch.zeros((p_max,), dtype=torch.int32, device=device),
        next_page=0)


def assign_initial_pages(store: GraphStore, spec: LayoutSpec) -> GraphStore:
    """Greedy page placement for the base index: consecutive ids share
    pages, ``per_page`` records to a page."""
    n = store.n_max
    per = spec.per_page
    dev = store.device
    n_pages = -(-n // per)
    if n_pages > store.p_max:
        raise ValueError(f"initial placement needs {n_pages} pages, "
                         f"the store has {store.p_max}")
    pages = (torch.arange(n, device=dev) // per).to(torch.int32)
    live = torch.zeros_like(store.page_live)
    live[:n_pages] = torch.clamp(
        n - torch.arange(n_pages, device=dev) * per, max=per).to(torch.int32)
    return dataclasses.replace(store, edge_page=pages, page_live=live,
                               next_page=n_pages)


def relocate_edgelists(store: GraphStore, vertex_ids: torch.Tensor,
                       valid: torch.Tensor, spec: LayoutSpec,
                       first_pages: torch.Tensor | None = None):
    """Move the modified vertices' edgelists onto fresh pages.

    ``vertex_ids`` [M] int32 with its ``valid`` mask: the co-updated
    vertices of one insertion, the new vertex first (always valid).  They
    are gathered onto ``ceil(M / per)`` fresh pages; old slots are
    invalidated through ``page_live``.  With a leading dimension [k, M],
    k insertions whose vertex sets are disjoint relocate at once.

    Fresh pages come from the bump allocator (row j at ``next_page + j *
    ceil(M / per)``, and ``next_page`` advances), or, when the caller has
    reserved them, from ``first_pages`` [k].  A valid slot's page is its
    position's, ``first + i // per``, so a row's invalid slots leave holes
    (the reference's page ids).  The valid ids of one call must be
    distinct; any slot, the first included, may be invalid.  Updates
    ``edge_page`` and ``page_live`` in place; returns (store,
    pages_written int64 per row).  Raises if the fresh pages run past the
    page budget.
    """
    squeeze = vertex_ids.dim() == 1
    if squeeze:
        vertex_ids, valid = vertex_ids[None], valid[None]
    per = spec.edgelists_per_page
    k, m = vertex_ids.shape
    n_new = -(-m // per)
    dev = vertex_ids.device
    next_page = store.next_page
    if first_pages is None:
        if next_page + k * n_new > store.p_max:
            raise RuntimeError(
                f"edge page {next_page + k * n_new - 1} is past the page "
                f"budget ({store.p_max} pages)")
        first_pages = next_page + torch.arange(k, device=dev) * n_new
        next_page += k * n_new
    ids = vertex_ids.long()
    old = store.edge_page[torch.where(valid, ids, 0)].long()
    dec_ok = valid & (old >= 0)
    store.page_live.index_add_(0, torch.where(dec_ok, old, 0).reshape(-1),
                               -dec_ok.to(torch.int32).reshape(-1))
    slot_page = first_pages.long()[:, None] + \
        torch.arange(m, device=dev) // per
    # each valid slot adds (new - old) to its own pointer and an invalid
    # one adds 0 to vertex 0's (the reference's scatter writes vertex 0's
    # old value there and can lose vertex 0's own move, ROADMAP queue 3)
    store.edge_page.index_add_(
        0, torch.where(valid, ids, 0).reshape(-1),
        torch.where(valid, slot_page - old, 0).reshape(-1).to(torch.int32))
    store.page_live.index_add_(0, slot_page.reshape(-1),
                               valid.to(torch.int32).reshape(-1))
    n_valid = valid.sum(1)
    written = torch.where(n_valid > 0, -(-n_valid // per), 0).to(torch.int64)
    return (dataclasses.replace(store, next_page=next_page),
            written[0] if squeeze else written)


def grow_pages(store: GraphStore, p_max: int) -> GraphStore:
    """The store with its page space grown to ``p_max`` pages (new pages
    hold nothing).  :func:`page_budget` covers the build and one insert
    per slot; a maintenance pass bump-allocates on top of that (a repair
    block's ``ceil(block / per)`` pages, a refined vertex's ``ceil((1 +
    r) / per)``) until its defrag resets the allocator."""
    if p_max <= store.p_max:
        return store
    live = torch.zeros((p_max,), dtype=torch.int32, device=store.device)
    live[:store.p_max] = store.page_live
    return dataclasses.replace(store, page_live=live)


# ---------------------------------------------------------------------------
# Defragmentation (maintenance pass)
# ---------------------------------------------------------------------------

def defrag_edgelists(store: GraphStore, holders: torch.Tensor,
                     spec: LayoutSpec):
    """Re-pack every page-holding vertex's edgelist contiguously from page
    0 (port of ``repro/core/layout.py`` ``defrag_edgelists``).

    ``holders`` [N_max] bool: the vertices that keep an edge page (live
    ones and tombstoned ones not reclaimed yet); every other vertex gets
    ``edge_page = -1``.  Consecutive holder ids share pages, ``per_page``
    to a page; ``page_live`` is rebuilt from scratch and ``next_page``
    reset, so the page space stays bounded by the churn of one
    maintenance cycle.  Returns (store, changed [P_max] bool: the old and
    new pages of every moved vertex, which the caller invalidates in the
    cache, n_pages: host int)."""
    per = spec.per_page
    p_max = store.p_max
    rank = torch.cumsum(holders.to(torch.int64), 0) - 1
    new_page = torch.where(holders, rank // per, -1)
    n_hold = int(holders.sum())
    n_pages = -(-n_hold // per)
    page_live = torch.zeros_like(store.page_live).index_add_(
        0, new_page.clamp(min=0), holders.to(torch.int32))
    old = store.edge_page.long()
    moved = old != new_page
    hit = torch.zeros((p_max,), dtype=torch.int32, device=store.device)
    for pages, ok in ((old, moved & (old >= 0)), (new_page, moved & holders)):
        hit.index_add_(0, torch.where(ok, pages, 0), ok.to(torch.int32))
    store = dataclasses.replace(store, edge_page=new_page.to(torch.int32),
                                page_live=page_live, next_page=n_pages)
    return store, hit > 0, n_pages
