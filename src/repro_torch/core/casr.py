"""Convergence-Aware Speculative Reranking (CASR, Algorithm 1), batch-first
(port of ``repro/core/casr.py``; :func:`casr_rerank` also stands in for
the reference's ``casr_rerank_many``).

Vectors are fetched from the slow tier in groups of ``s`` in PQ-distance
order; each group's I/O overlaps the previous group's exact-distance
compute, and a lane stops when its running exact top-K is stable.  The
group speculatively issued in the round that converges is charged, as
the paper's io_uring pipeline pays it.  All lanes that are still running
share the same group index, so each round reranks one group of ``s``
rows per lane through :func:`repro_torch.kernels.ops.rerank_l2` — only
the rows it takes; the reference reranks the whole pool and masks, which
gives identical values.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.iomodel import IOCounters, PAGE_BYTES
from repro_torch.core.layout import GraphStore, LayoutSpec
from repro_torch.kernels import ops as kernel_ops

INF = 3.4e38


class CASRResult(NamedTuple):
    ids: torch.Tensor            # [B, P] candidate ids (input order)
    exact_d: torch.Tensor        # [B, P] exact distances (INF not loaded)
    loaded: torch.Tensor         # [B, P] bool
    topk_ids: torch.Tensor       # [B, k] (-1 padded)
    topk_d: torch.Tensor         # [B, k]
    n_loaded: torch.Tensor       # [B] int64 vectors fetched
    n_groups: torch.Tensor       # [B] int32 pipeline rounds executed
    rerank_rounds: torch.Tensor  # [B] int32 serial I/O rounds
    counters: IOCounters


def _topk_ids(ids: torch.Tensor, d: torch.Tensor, k: int):
    """Per lane, the k smallest by d (stable), through the pool merge."""
    out_d, out_i = kernel_ops.pool_merge(
        d[:, :k].contiguous(), ids[:, :k].contiguous(),
        d[:, k:].contiguous(), ids[:, k:].contiguous())
    return torch.where(out_d < INF, out_i, -1), out_d


def _charge_vec_reads(counters: IOCounters, spec: LayoutSpec,
                      n: torch.Tensor, useful: bool = True) -> IOCounters:
    """n full-vector reads from the decoupled vector file."""
    n = n.to(torch.int64)
    bytes_ = n * (spec.vector_pages_per_read * PAGE_BYTES)
    payload = n * spec.vector_bytes
    field = "useful_vec_bytes_read" if useful else "wasted_vec_bytes_read"
    return dataclasses.replace(
        counters, read_requests=counters.read_requests + n,
        pad_bytes_read=counters.pad_bytes_read + (bytes_ - payload),
        **{field: getattr(counters, field) + payload})


def casr_rerank(store: GraphStore, spec: LayoutSpec, q: torch.Tensor,
                pool_ids: torch.Tensor, counters: IOCounters, *, k: int,
                s: int) -> CASRResult:
    """Algorithm 1 over PQ-sorted pools ``pool_ids`` [B, P] (-1 padded at
    the tail) for queries ``q`` [B, D]; ``counters`` [B]."""
    b, p = pool_ids.shape
    dev = pool_ids.device
    s = max(min(s, p), 1)
    max_groups = -(-p // s)
    valid = pool_ids >= 0
    safe = pool_ids.clamp(min=0).long()
    exact_d = torch.full((b, p), INF, device=dev)
    loaded = torch.zeros((b, p), dtype=torch.bool, device=dev)

    def load_group(g: int, active: torch.Tensor, counters: IOCounters):
        """Fetch group g (positions [g*s, g*s+s)) for the active lanes."""
        lo, hi = g * s, min(g * s + s, p)
        take = valid[:, lo:hi] & ~loaded[:, lo:hi] & active[:, None]
        n = take.sum(1)
        counters = _charge_vec_reads(counters, spec, n)
        d = kernel_ops.rerank_l2(q, store.vectors[safe[:, lo:hi]])
        exact_d[:, lo:hi] = torch.where(take, d, exact_d[:, lo:hi])
        loaded[:, lo:hi] |= take
        return n, counters

    # pipeline start: group 0 is loaded before the loop (Alg 1 line 3)
    everyone = torch.ones((b,), dtype=torch.bool, device=dev)
    n_loaded, counters = load_group(0, everyone, counters)
    topk_prev = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    rounds = torch.ones((b,), dtype=torch.int32, device=dev)
    pos = torch.arange(p, device=dev)
    g = 1
    active = everyone
    while g <= max_groups and bool(active.any()):
        if g < max_groups:      # speculative next-group I/O
            n, counters = load_group(g, active, counters)
            n_loaded = n_loaded + n
        known_d = torch.where(loaded & (pos < g * s), exact_d, INF)
        topk_new, _ = _topk_ids(pool_ids, known_d, k)
        stable = (topk_new == topk_prev).all(1) & (topk_prev >= 0).any(1)
        act = active[:, None]
        topk_prev = torch.where(act, topk_new, topk_prev)
        done = torch.where(active, stable | (g >= max_groups), done)
        rounds += active.to(rounds.dtype)
        g += 1
        active = ~done
    known_d = torch.where(loaded, exact_d, INF)
    topk_ids, topk_d = _topk_ids(pool_ids, known_d, k)
    return CASRResult(ids=pool_ids, exact_d=exact_d, loaded=loaded,
                      topk_ids=topk_ids, topk_d=topk_d, n_loaded=n_loaded,
                      n_groups=rounds - 1,
                      rerank_rounds=rounds.clamp(max=2), counters=counters)
