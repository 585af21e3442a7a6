"""The plain reference: exact nearest neighbours by brute force.

Plain PyTorch, independent of the port: it imports nothing of it and
takes nothing it made.  The corpus is the benchmark's own copy of the
base it generated, and every distance is a squared L2 computed in
float64 by default.

``dtype=torch.float32, tf32=True`` computes the same in the precision
below the configuration's (float32 with TF32 off): the control that the
comparison must fail.
"""
from __future__ import annotations

import contextlib

import torch

QUERY_BLOCK = 256
PAIR_BLOCK = 4096


@contextlib.contextmanager
def _tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
         dtype=torch.float64, tf32: bool = False):
    """Exact top ``k`` of each query [Q, D] over ``corpus`` [N, D]: (ids
    [Q, k] int64, squared distances [Q, k] in ``dtype``), nearest first,
    ties by id."""
    x = corpus.to(dtype)
    xn = (x * x).sum(1)
    ids, dists = [], []
    with _tf32(tf32):
        for s in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[s:s + QUERY_BLOCK].to(dtype)
            d = (q * q).sum(1, keepdim=True) + xn[None] - 2.0 * (q @ x.T)
            # stable sort: equal distances keep id order; the first k are
            # copied out, so that no block's whole sort stays alive
            v, i = torch.sort(d, dim=1, stable=True)
            ids.append(i[:, :k].clone())
            dists.append(v[:, :k].clone())
    return torch.cat(ids), torch.cat(dists)


def pair_dist(queries: torch.Tensor, corpus: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Exact squared L2 [Q, k] float64 from each query to the corpus rows
    ``ids`` [Q, k] names (NaN where an id is outside the corpus)."""
    n = corpus.shape[0]
    out = []
    for s in range(0, queries.shape[0], PAIR_BLOCK):
        i = ids[s:s + PAIR_BLOCK].to(corpus.device).long()
        ok = (i >= 0) & (i < n)
        rows = corpus[i.clamp(0, n - 1)].to(torch.float64)
        q = queries[s:s + PAIR_BLOCK].to(torch.float64)
        d = ((q[:, None, :] - rows) ** 2).sum(-1)
        out.append(torch.where(ok, d, torch.nan))
    return torch.cat(out)
