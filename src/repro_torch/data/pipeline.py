"""Deterministic synthetic data (port of ``repro/data/pipeline.py``): the
LM token stream ``TokenStream`` and the vector streams
``make_clustered``, ``query_stream``, ``insert_stream``.

``TokenStream`` is bit-exact with the reference: batch ``t`` of shard
``s`` is a pure function of ``(seed, t, s)`` through the port's threefry
(:mod:`repro_torch.random`).  The vector streams draw from an explicit
``torch.Generator`` instead; pass one that lives on the device the data
should be made on.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Markov-ish synthetic LM data: structured enough that a model trains,
    cheap enough to generate on the fly."""

    vocab_size: int
    seq_len: int
    batch: int                      # per-shard batch
    seed: int = 0
    n_shards: int = 1

    def make_batch(self, step: int, shard: int = 0, device=None) -> dict:
        """``{"tokens": int32 [batch, seq_len]}`` on ``device``."""
        dev = resolve_device(device)
        key = jr.fold_in(jr.fold_in(jr.PRNGKey(self.seed), step), shard)
        k1, k2 = jr.split(key)
        # low-order structure: tokens follow t[i+1] = (31*t[i] + 17 + n) % V
        t = jr.randint(k1, (self.batch,), 0, self.vocab_size).to(dev)
        noise = jr.randint(k2, (self.seq_len, self.batch), 0, 7).to(dev)
        toks = []
        for n in noise:                  # the reference's lax.scan
            t = (t * 31 + 17 + n) % self.vocab_size
            toks.append(t)
        return {"tokens": torch.stack(toks, dim=1).to(torch.int32)}

    def global_batch(self, step: int, device=None) -> dict:
        """All shards concatenated (single-host runs)."""
        parts = [self.make_batch(step, s, device)
                 for s in range(self.n_shards)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------------------
# GVS vector streams
# ---------------------------------------------------------------------------


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
