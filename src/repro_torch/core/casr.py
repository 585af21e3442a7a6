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

The classifier (:func:`casr_stop_point`) and the warm-up calibration
(:func:`calibrate_group_size`) run the same loop: the reference's stop
point is the count of positions that CASR's own loop covers, so it comes
from one more ``casr_rerank`` launch a wave.
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


# ---------------------------------------------------------------------------
# Classifier + calibration
# ---------------------------------------------------------------------------

def casr_stop_point(q: torch.Tensor, vectors: torch.Tensor,
                    pool_ids: torch.Tensor, *, k: int, s: int = 1
                    ) -> torch.Tensor:
    """Vectors CASR with group size ``s`` would load for each lane's pool
    ``pool_ids`` [B, P] (queries ``q`` [B, D]), the speculative group
    included, capped by the lane's valid count -> [B] int64.  It is the
    paper's PQ-distance-based classifier of useful against wasted vector
    reads (Fig. 4a) and the calibration's sample.

    The reference runs the convergence recurrence on free exact distances:
    it stops at the first g >= 1 where the top-k of the first g and g + 1
    groups agree and hold an id, and returns min((g + 1) * s, valid).
    CASR's loop makes that same comparison in round g + 1 and stops there,
    after g + 2 rounds, or runs all G + 1 rounds (G = ceil(P / s)) when
    nothing agrees, where the cap gives the valid count either way.  So
    the count is min(rounds * s, valid), with ``rounds`` from one
    ``casr_rerank`` call.  Its ``n_loaded`` is not the count: it skips -1
    holes (tombstoned candidates) that the reference's positions count."""
    p = pool_ids.shape[1]
    s = max(min(s, p), 1)
    rounds = kernel_ops.casr_rerank(q.contiguous(), vectors,
                                    pool_ids.contiguous(), k=k, s=s)[5]
    valid = (pool_ids >= 0).sum(1)
    return torch.minimum(rounds.to(torch.int64) * s, valid)


def calibrate_group_size(vectors: torch.Tensor, pools: torch.Tensor,
                         queries: torch.Tensor, *, k: int) -> int:
    """Warm-up calibration of s (paper §5.2): the 25th percentile of the
    s = 1 stop points over the queries' pools [Q, P], interpolated
    linearly in float32 as ``jnp.percentile`` does (the weights are
    quarters and the stop points small integers, so both compute it
    exactly), then at least 1."""
    stops = casr_stop_point(queries, vectors, pools, k=k, s=1)
    s = torch.quantile(stops.to(torch.float32), 0.25,
                       interpolation="linear")
    return int(max(int(s), 1))
