"""Entrance graph, build side (port of ``repro/core/entrance.py``).

A small in-memory sample (~1%) of the proximity graph with reduced
out-degree ``R_ent`` that seeds every traversal.  It is linked by
symmetric PQ distances, so the build never touches the slow tier.  The
NAVIS update path (``navis_update``, ``add_member``) comes with the
insert slice.
"""
from __future__ import annotations

import dataclasses

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
