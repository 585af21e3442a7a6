"""Convergence-Aware Speculative Reranking (CASR, Algorithm 1), batch-first
(port of ``repro/core/casr.py``; :func:`casr_rerank` also stands in for
the reference's ``casr_rerank_many``).

Vectors are fetched from the slow tier in groups of ``s`` in PQ-distance
order; each group's I/O overlaps the previous group's exact-distance
compute, and a lane stops when its running exact top-K is stable.  The
group speculatively issued in the round that converges is charged, as
the paper's io_uring pipeline pays it.  The group loop of the whole wave
runs in one call of :func:`repro_torch.kernels.ops.casr_rerank` (one
kernel launch on the card, the plain batch-first loop on the CPU); it
reranks only the rows it loads, where the reference reranks the whole
pool and masks, which gives identical values.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.iomodel import IOCounters, PAGE_BYTES
from repro_torch.core.layout import GraphStore, LayoutSpec
from repro_torch.kernels import ops as kernel_ops


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
    s = max(min(s, pool_ids.shape[1]), 1)
    exact_d, loaded, topk_ids, topk_d, n_loaded, rounds = \
        kernel_ops.casr_rerank(q.contiguous(), store.vectors,
                               pool_ids.contiguous(), k=k, s=s)
    # the charge is linear in n: one charge of the total equals the
    # reference's charge per group
    counters = _charge_vec_reads(counters, spec, n_loaded)
    return CASRResult(ids=pool_ids, exact_d=exact_d, loaded=loaded,
                      topk_ids=topk_ids, topk_d=topk_d, n_loaded=n_loaded,
                      n_groups=rounds - 1,
                      rerank_rounds=rounds.clamp(max=2), counters=counters)
