"""The benchmark's corpus model, drawn from ``--seed``.

Each cluster c has a centroid mu_c and its own orthonormal basis U_c of
``d_int`` columns.  A vector is ``mu_c + U_c z + sigma_eps * eps`` with
``z ~ N(0, sigma_z^2 I)`` and ``eps ~ N(0, I_dim)``: points of a cluster
spread along a low-dimensional subspace, as real embeddings do, so the
exact top 10 of a query stands clear of its ranks 11 and beyond.  The
isotropic clusters of the port's ``data/pipeline.make_clustered`` put
every point of a cluster at nearly the same distance from a query in
768 dimensions, which makes the exact top 10 close to arbitrary.

Queries are fresh draws from the same mixture.

Everything is made on the generator's device in a few large calls.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mixture:
    centroids: torch.Tensor     # [C, D]
    bases: torch.Tensor         # [C, D, d_int], orthonormal columns
    sigma_z: float
    sigma_eps: float


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    return torch.Generator(device=device).manual_seed(
        int(seed) & 0xFFFF_FFFF_FFFF_FFFF)


def mixture(gen: torch.Generator, corpus: dict, dim: int) -> Mixture:
    """The cluster mixture that ``corpus`` (a configuration's ``corpus``
    block) describes, drawn from ``gen``."""
    dev = gen.device
    c, d_int = int(corpus["n_clusters"]), int(corpus["d_int"])
    cents = torch.randn((c, dim), generator=gen, device=dev) * \
        float(corpus["centroid_scale"])
    raw = torch.randn((c, dim, d_int), generator=gen, device=dev)
    bases, _ = torch.linalg.qr(raw)
    return Mixture(cents, bases.contiguous(), float(corpus["sigma_z"]),
                   float(corpus["sigma_eps"]))


def _place(gen: torch.Generator, mix: Mixture, assign: torch.Tensor,
           centres: torch.Tensor) -> torch.Tensor:
    """Vectors around ``centres`` [n, D], each in the subspace of its
    cluster ``assign`` [n]: cluster by cluster, one [n_c, d_int] @
    [d_int, D] product each."""
    dev = gen.device
    n, dim = centres.shape
    c, _, d_int = mix.bases.shape
    z = torch.randn((n, d_int), generator=gen, device=dev) * mix.sigma_z
    out = centres + mix.sigma_eps * torch.randn((n, dim), generator=gen,
                                                device=dev)
    order = torch.argsort(assign, stable=True)
    start = 0
    for ci, cnt in enumerate(torch.bincount(assign, minlength=c).tolist()):
        if cnt:
            rows = order[start:start + cnt]
            out[rows] += z[rows] @ mix.bases[ci].T
        start += cnt
    return out


def draw(gen: torch.Generator, mix: Mixture, n: int) -> torch.Tensor:
    """``n`` vectors [n, D] float32 from the mixture."""
    c = mix.centroids.shape[0]
    assign = torch.randint(0, c, (n,), generator=gen, device=gen.device)
    return _place(gen, mix, assign, mix.centroids[assign])
