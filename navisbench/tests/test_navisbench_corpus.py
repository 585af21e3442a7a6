"""The benchmark's corpus: seeded, repeatable, and with an exact top 10
that stands clear of ranks 11 and beyond."""
import json
from pathlib import Path

import pytest
import torch

from navisbench import corpus

PKG = Path(__file__).resolve().parents[1]


def _corpus(name: str) -> tuple[dict, int]:
    cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
    return cfg["corpus"], cfg["dim"]


def _draws(seed: int, block: dict, dim: int):
    g = corpus.generator(seed, "cpu")
    mix = corpus.mixture(g, block, dim)
    return corpus.draw(g, mix, 300), corpus.draw(g, mix, 48)


@pytest.mark.parametrize("name", ["deep96"])
@pytest.mark.parametrize("seed", [0, 2**31 + 12_345, 2**40 + 7])
def test_draws_repeat_by_seed(name, seed):
    block, dim = _corpus(name)
    a, b = _draws(seed, block, dim), _draws(seed, block, dim)
    other = _draws(seed + 1, block, dim)
    for x, y, z in zip(a, b, other):
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
        assert x.dtype == torch.float32 and x.shape[1] == dim


def test_bases_are_orthonormal():
    block, dim = _corpus("deep96")
    mix = corpus.mixture(corpus.generator(3, "cpu"), block, dim)
    eye = torch.eye(block["d_int"]).expand(block["n_clusters"], -1, -1)
    gram = mix.bases.transpose(1, 2) @ mix.bases
    assert torch.allclose(gram, eye, atol=1e-5)


def _gaps(x, q, k=10):
    d = torch.cdist(q.double(), x.double()) ** 2
    v = d.topk(k + 1, largest=False).values
    return (v[:, k] - v[:, k - 1]) / v[:, k - 1]


@pytest.mark.parametrize("name,n", [("deep96", 4000)])
def test_top10_stands_clear(name, n):
    """On the subspace mixture the 10th and 11th exact neighbours sit
    apart; on isotropic clusters of the same spread (the port's
    ``make_clustered``) they do not."""
    block, dim = _corpus(name)
    g = corpus.generator(11, "cpu")
    mix = corpus.mixture(g, block, dim)
    x, q = corpus.draw(g, mix, n), corpus.draw(g, mix, 200)
    gap = _gaps(x, q)
    spread = (block["sigma_z"] ** 2 * block["d_int"] +
              block["sigma_eps"] ** 2 * dim) ** 0.5 / dim ** 0.5
    cents = mix.centroids
    a = torch.randint(0, cents.shape[0], (n + 200,), generator=g)
    iso = cents[a] + spread * torch.randn((n + 200, dim), generator=g)
    iso_gap = _gaps(iso[:n], iso[n:])
    assert float(gap.median()) > 3 * float(iso_gap.median())
    assert float((gap < 1e-3).double().mean()) < 0.15
