"""Synthetic vector streams (port of the GVS half of
``repro/data/pipeline.py``: ``make_clustered``, ``query_stream``,
``insert_stream``).

Randomness comes from an explicit ``torch.Generator``; pass one that lives
on the device the data should be made on.
"""
from __future__ import annotations

import torch


def make_clustered(gen: torch.Generator, n: int, dim: int, *,
                   n_clusters: int = 32, scale: float = 3.0,
                   noise: float = 1.0):
    """Clustered-Gaussian corpus.  Returns (vectors [n, dim], assignments
    [n], centroids [n_clusters, dim]) on ``gen``'s device."""
    dev = gen.device
    cents = torch.randn((n_clusters, dim), generator=gen, device=dev) * scale
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
    vecs = cents[assign] + noise * torch.randn((n, dim), generator=gen,
                                               device=dev)
    return vecs, assign, cents


def query_stream(gen: torch.Generator, cents: torch.Tensor, n: int, *,
                 noise: float = 1.0) -> torch.Tensor:
    """Queries drawn from the same cluster mixture as the corpus."""
    dev = gen.device
    assign = torch.randint(0, cents.shape[0], (n,), generator=gen,
                           device=dev)
    return cents[assign] + noise * torch.randn((n, cents.shape[1]),
                                               generator=gen, device=dev)


def insert_stream(gen: torch.Generator, cents: torch.Tensor, n: int, *,
                  noise: float = 1.0, drift: float = 0.0) -> torch.Tensor:
    """Fresh vectors to insert.  ``drift`` shifts the cluster mixture: the
    paper's newly inserted regions, which a static entrance graph drifts
    away from (§3.2)."""
    dev = gen.device
    assign = torch.randint(0, cents.shape[0], (n,), generator=gen,
                           device=dev)
    shift = drift * torch.randn(cents.shape, generator=gen, device=dev)
    return (cents + shift)[assign] + noise * torch.randn(
        (n, cents.shape[1]), generator=gen, device=dev)
