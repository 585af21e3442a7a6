"""Entrance graph: build + NAVIS-update (port of
``repro/core/entrance.py``: ``build_entrance``, ``link_members``,
``navis_update``, ``add_member``).

A small in-memory sample (~1%) of the proximity graph with reduced
out-degree ``R_ent`` that seeds every traversal.  It is linked by
symmetric PQ distances, so it never touches the slow tier.  NAVIS keeps it
fresh by piggybacking each insertion's explored sets (Algorithm 2):

    E_inter = E_pos ∩ G_ent         (on-disk pool ∩ entrance members)
    q.nbr   = E_inter ⊕ E_ent       (fill to R_ent, E_inter first)
    reciprocal links + prune         (drop farthest by symmetric-PQ distance)

:func:`navis_update` and :func:`add_member` (maintenance's top-up of a
static entrance) write the entrance tensors in place (the operation that
calls them owns its copy of the state).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import pq as pq_mod
from repro_torch.device import resolve_device

INF = 3.4e38


@dataclasses.dataclass
class EntranceGraph:
    """ids [C_max] int32 main-graph ids (-1 empty); edges [C_max, R_ent]
    int32 indices into ``ids``; count live entries (host int);
    main_to_ent [N_max] int32 inverse map (-1 absent)."""

    ids: torch.Tensor
    edges: torch.Tensor
    count: int
    main_to_ent: torch.Tensor

    @property
    def c_max(self) -> int:
        return self.ids.shape[0]

    @property
    def r_ent(self) -> int:
        return self.edges.shape[1]


def entrance_hop_stats(ent: EntranceGraph) -> dict:
    """Diagnostics: the live member count and the members' mean degree."""
    live = ent.ids >= 0
    deg = (ent.edges >= 0).sum(1) * live
    return {"count": ent.count,
            "mean_degree": float(deg.sum()) / max(int(live.sum()), 1)}


def empty_entrance(c_max: int, r_ent: int, n_max: int,
                   device=None) -> EntranceGraph:
    device = resolve_device(device)
    full = lambda *s: torch.full(s, -1, dtype=torch.int32, device=device)
    return EntranceGraph(ids=full(c_max), edges=full(c_max, r_ent), count=0,
                         main_to_ent=full(n_max))


def build_entrance(key: torch.Tensor, codes: torch.Tensor,
                   sym_tables: torch.Tensor, n_live: int, *, c_max: int,
                   r_ent: int, sample_frac: float = 0.01,
                   n_max: int | None = None) -> EntranceGraph:
    """Sample ``sample_frac`` of the live prefix and kNN-link it."""
    n_max = n_max or codes.shape[0]
    n_sample = max(min(int(n_live * sample_frac), c_max), min(n_live, 2))
    perm = jr.permutation(key, n_live)[:n_sample].to(codes.device)
    return link_members(perm.to(torch.int32), codes, sym_tables,
                        c_max=c_max, r_ent=r_ent, n_max=n_max)


def link_members(members: torch.Tensor, codes: torch.Tensor,
                 sym_tables: torch.Tensor, *, c_max: int, r_ent: int,
                 n_max: int) -> EntranceGraph:
    """kNN-link an explicit member list [S]; the medoid-most member is
    swapped to slot 0, which ``entrance_search`` seeds from."""
    dev = codes.device
    s = members.shape[0]
    d = pq_mod.sym_distance_matrix(sym_tables, codes[members.long()])
    d = d + torch.eye(s, device=dev) * INF
    med = int(d.sum(dim=1).argmin())
    swap = torch.arange(s, device=dev)
    swap[0], swap[med] = med, 0
    members = members[swap]
    d = d[swap][:, swap]

    k = min(r_ent, s - 1)
    nbr = torch.sort(d, dim=1, stable=True).indices[:, :k]
    edges = torch.full((c_max, r_ent), -1, dtype=torch.int32, device=dev)
    edges[:s, :k] = nbr.to(torch.int32)
    ids = torch.full((c_max,), -1, dtype=torch.int32, device=dev)
    ids[:s] = members
    main_to_ent = torch.full((n_max,), -1, dtype=torch.int32, device=dev)
    main_to_ent[members.long()] = torch.arange(s, dtype=torch.int32,
                                               device=dev)
    return EntranceGraph(ids=ids, edges=edges, count=s,
                         main_to_ent=main_to_ent)


# ---------------------------------------------------------------------------
# NAVIS-update (Algorithm 2)
# ---------------------------------------------------------------------------

def navis_update(ent: EntranceGraph, new_id: int, new_code: torch.Tensor,
                 e_pos: torch.Tensor, e_ent: torch.Tensor, graph_count: int,
                 codes: torch.Tensor, sym_tables: torch.Tensor, *,
                 r_ent_frac: float = 0.01, n_members: int | None = None,
                 is_member: bool | None = None) -> EntranceGraph:
    """Algorithm 2 for the vertex ``new_id`` with PQ code ``new_code``
    [M].  ``e_pos`` [P]: the position seek's explored pool (PQ-sorted);
    ``e_ent`` [E]: the entrance search's explored set; main ids, -1
    padded.  Runs only while the *live* members number fewer than
    ``r_ent_frac * graph_count``, a slot is left, and ``new_id`` is not a
    member yet.  ``n_members`` and ``is_member`` let a caller that tracks
    them on the host skip reading them from the tensors (two syncs on the
    card).  Returns the graph with ``count`` advanced when it promoted.

    The reciprocal links are wired as in :func:`_join`."""
    if n_members is None:
        n_members = int((ent.ids >= 0).sum())
    if is_member is None:
        is_member = new_id >= 0 and int(ent.main_to_ent[new_id]) >= 0
    # float32 compare, as the reference's
    want = (np.float32(n_members) <
            np.float32(r_ent_frac) * np.float32(graph_count))
    if not (want and ent.count < ent.c_max and not is_member and
            new_id >= 0):
        return ent
    dev = ent.ids.device
    m2e = ent.main_to_ent

    def as_slots(x):
        return torch.where(x >= 0, m2e[x.clamp(min=0).long()], -1)

    # lines 2-3: E_inter first, then E_ent; first occurrence kept
    cand = torch.cat([as_slots(e_pos), as_slots(e_ent)])          # [P+E]
    ar = torch.arange(cand.shape[0], dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    first = torch.full((ent.c_max,), big, dtype=torch.int32, device=dev)
    first = first.scatter_reduce(0, cand.clamp(min=0).long(),
                                 torch.where(cand >= 0, ar, big), "amin")
    keep = (cand >= 0) & (first[cand.clamp(min=0).long()] == ar)
    order = torch.sort(torch.where(keep, ar, big), stable=True).indices
    nbrs = torch.where(keep[order], cand[order], -1)[:ent.r_ent]

    # line 6: G_ent ∪ q; lines 4-5, 7-8: reciprocal links
    return _join(ent, new_id, nbrs, new_code, codes, sym_tables)


def add_member(ent: EntranceGraph, vid: int, codes: torch.Tensor,
               sym_tables: torch.Tensor) -> EntranceGraph:
    """Append the live vertex ``vid`` as a member, wired to its ``R_ent``
    symmetric-PQ-nearest live members (stable order) with reciprocal links
    + prune: maintenance's top-up of a static entrance (port of
    ``repro/core/entrance.py`` ``add_member``).  No-op when ``vid`` is a
    member already or the slot high-water mark reached ``c_max``.  Writes
    the entrance tensors in place (the caller owns its copy)."""
    if not (ent.count < ent.c_max and vid >= 0 and
            int(ent.main_to_ent[vid]) < 0):
        return ent
    live = ent.ids >= 0
    new_code = codes[vid]
    d = pq_mod.sym_distance(sym_tables, new_code[None],
                            codes[ent.ids.clamp(min=0).long()][None])[0]
    order = torch.sort(torch.where(live, d, INF), stable=True).indices
    nbrs = torch.where(live[order], order, -1)[:ent.r_ent].to(torch.int32)
    return _join(ent, vid, nbrs, new_code, codes, sym_tables)


def _join(ent: EntranceGraph, vid: int, nbrs: torch.Tensor,
          new_code: torch.Tensor, codes: torch.Tensor,
          sym_tables: torch.Tensor) -> EntranceGraph:
    """Put ``vid`` (code ``new_code``) at slot ``count`` with edge slots
    ``nbrs`` [R_ent], then add the slot to each neighbor's row, pruning
    the farthest edge of a full row when the new member is closer (codes
    are in host memory: no I/O).  The reference wires one neighbor at a
    time; the neighbors are distinct slots, so each step reads and writes
    only its own row, and the port wires them all at once."""
    slot = ent.count
    ent.ids[slot] = vid
    ent.main_to_ent[vid] = slot
    ent.edges[slot] = nbrs
    p = nbrs.long()
    do = (p >= 0) & (p != slot)
    safe = p.clamp(min=0)
    rows = ent.edges[safe]                                    # [R_ent, R]
    occupied = rows >= 0
    free = (~occupied).to(torch.int8).argmax(1)
    has_free = ~occupied.all(1)
    p_codes = codes[ent.ids[safe].long()]                     # [R_ent, M]
    # a row entry of a scrubbed slot reads ids -1, which wraps to the last
    # code row as the reference's gather does
    targets = torch.cat([codes[ent.ids[rows.clamp(min=0).long()].long()],
                         new_code[None, None].expand(p.shape[0], 1, -1)], 1)
    d = pq_mod.sym_distance(sym_tables, p_codes, targets)   # [R_ent, R+1]
    d_row = torch.where(occupied, d[:, :-1], -INF)
    worst = d_row.argmax(1)
    d_worst = d_row.gather(1, worst[:, None])[:, 0]
    write = do & (has_free | (d[:, -1] < d_worst))
    tgt = torch.where(has_free, free, worst)
    new_rows = rows.scatter(1, tgt[:, None], torch.full_like(rows[:, :1],
                                                             slot))
    # rows not written rewrite the new slot's row unchanged (no p is the
    # slot), so the scatter needs no mask compaction, hence no sync
    ent.edges.index_put_((torch.where(write, safe, slot),), torch.where(
        write[:, None], new_rows, ent.edges[slot][None]))
    return dataclasses.replace(ent, count=ent.count + 1)
