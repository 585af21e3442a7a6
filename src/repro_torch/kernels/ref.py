"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``,
plus the CASR group loop of ``repro/core/casr.py``).

Batch-first: every function takes a leading lane dimension ``[B]`` (one
query of a wave per lane).  They are what :mod:`repro_torch.kernels.ops`
runs for tensors on the CPU, and what ``chip_smoke.py`` holds the CUDA
kernels against on the card.  They keep the input dtype.

``adc_distance_ref`` sums the subspaces one at a time in order ``m = 0,
1, ...``, as the TPU kernel's ``fori_loop`` does and as the CUDA kernel
does, so kernel and plain version agree bit for bit.  ``pool_merge_ref``
is a stable argsort, the TPU kernel's rank definition.
``rerank_l2_rows_ref`` reranks rows gathered by id,
``rerank_l2_shared_ref`` every lane against the same rows (on these
tensors, bit for bit what ``rerank_l2_rows_ref`` gives on those rows'
ids).  ``casr_rerank_ref``
is the CASR loop written batch-first over the rerank and merge plain
versions.  ``cache_apply`` is the cache kernels' plain version: the host
state machine of :class:`repro_torch.core.cache.HostCache`, run on the
state's tensors and written back into them.
"""
from __future__ import annotations

import torch

INF = 3.4e38


def adc_distance_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [B, M, 256]; codes [B, C, M] uint8 -> [B, C]."""
    vals = lut.gather(2, codes.transpose(1, 2).long())      # [B, M, C]
    acc = torch.zeros_like(vals[:, 0])
    for m in range(vals.shape[1]):
        acc = acc + vals[:, m]
    return acc


def rerank_l2_ref(q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """q [B, D]; xs [B, S, D] -> [B, S] squared L2 (difference form)."""
    diff = xs - q[:, None]
    return (diff * diff).sum(-1)


def rerank_l2_rows_ref(q: torch.Tensor, vectors: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """q [B, D]; rows ``ids`` [B, S] of ``vectors`` [N, D] -> [B, S]
    squared L2, INF where the id is -1."""
    d = rerank_l2_ref(q, vectors[ids.clamp(min=0).long()])
    return torch.where(ids >= 0, d, torch.full_like(d, INF))


def rerank_l2_shared_ref(q: torch.Tensor, rows: torch.Tensor,
                         count: int) -> torch.Tensor:
    """q [B, D]; rows [S, D], every lane's -> [B, S] squared L2
    (difference form) to rows ``< count``, INF from row ``count`` on."""
    d = ((q[:, None] - rows[None, :count]) ** 2).sum(-1)
    out = d.new_full((q.shape[0], rows.shape[0]), INF)
    out[:, :count] = d
    return out


def pool_merge_ref(pool_d, pool_ids, new_d, new_ids):
    """Keep the P smallest of each lane's ``pool ∪ new`` (stable on ties).
    pool [B, P], new [B, Q] -> ([B, P], [B, P]) ascending."""
    p = pool_d.shape[1]
    d = torch.cat([pool_d, new_d], dim=1)
    ids = torch.cat([pool_ids, new_ids], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :p]
    return d.gather(1, order), ids.gather(1, order)


def _topk(ids, d, k: int, pool_merge):
    """Per lane, the k smallest by d (stable), through the pool merge: the
    candidates' prefix is the "pool", their tail the new block.  ids are
    -1 where the distance is INF."""
    out_d, out_i = pool_merge(d[:, :k].contiguous(), ids[:, :k].contiguous(),
                              d[:, k:].contiguous(), ids[:, k:].contiguous())
    return torch.where(out_d < INF, out_i, -1), out_d


def casr_rerank_ref(q, vectors, pool_ids, k: int, s: int, *,
                    rerank_l2=rerank_l2_ref, pool_merge=pool_merge_ref):
    """CASR's group loop (Algorithm 1) for queries ``q`` [B, D] over
    PQ-sorted pools ``pool_ids`` [B, P] (-1 tail) of rows of ``vectors``
    [N, D], in groups of ``s`` (1 <= s <= P).  Returns (exact_d [B, P],
    loaded [B, P], topk_ids [B, k], topk_d [B, k], n_loaded [B] int64,
    rounds [B] int32).  All lanes that are still running share the group
    index, so each round reranks one group of ``s`` rows per lane through
    ``rerank_l2``; ``pool_merge`` takes the stable top-k.  Both default to
    the plain versions; passing the kernels' wrappers gives the loop of
    one launch of each per round."""
    b, p = pool_ids.shape
    dev = pool_ids.device
    max_groups = -(-p // s)
    valid = pool_ids >= 0
    safe = pool_ids.clamp(min=0).long()
    exact_d = torch.full((b, p), INF, device=dev)
    loaded = torch.zeros((b, p), dtype=torch.bool, device=dev)

    def load_group(g: int, active: torch.Tensor) -> torch.Tensor:
        """Fetch group g (positions [g*s, g*s+s)) for the active lanes."""
        lo, hi = g * s, min(g * s + s, p)
        take = valid[:, lo:hi] & ~loaded[:, lo:hi] & active[:, None]
        d = rerank_l2(q, vectors[safe[:, lo:hi]])
        exact_d[:, lo:hi] = torch.where(take, d, exact_d[:, lo:hi])
        loaded[:, lo:hi] |= take
        return take.sum(1)

    # pipeline start: group 0 is loaded before the loop (Alg 1 line 3)
    everyone = torch.ones((b,), dtype=torch.bool, device=dev)
    n_loaded = load_group(0, everyone)
    topk_prev = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    rounds = torch.ones((b,), dtype=torch.int32, device=dev)
    pos = torch.arange(p, device=dev)
    g = 1
    active = everyone
    while g <= max_groups and bool(active.any()):
        if g < max_groups:      # speculative next-group I/O
            n_loaded = n_loaded + load_group(g, active)
        known_d = torch.where(loaded & (pos < g * s), exact_d, INF)
        topk_new, _ = _topk(pool_ids, known_d, k, pool_merge)
        stable = (topk_new == topk_prev).all(1) & (topk_prev >= 0).any(1)
        topk_prev = torch.where(active[:, None], topk_new, topk_prev)
        done = torch.where(active, stable | (g >= max_groups), done)
        rounds += active.to(rounds.dtype)
        g += 1
        active = ~done
    known_d = torch.where(loaded, exact_d, INF)
    topk_ids, topk_d = _topk(pool_ids, known_d, k, pool_merge)
    return exact_d, loaded, topk_ids, topk_d, n_loaded, rounds


def cache_apply(policy: int, tables, *, traces=None, pages=None, kinds=None,
                kind: int = 0) -> torch.Tensor:
    """The cache kernels' plain version, with their signature: the state's
    tensors ``tables`` (``ops.CACHE_TABLES``' order), then trace rows
    ``traces`` [Q, T] (each up to its first -1) or an op stream ``pages``
    [N] with ``kinds`` [N] (or ``kind`` for all), -1 pages skipped.  Runs
    them on the host through :class:`~repro_torch.core.cache.HostCache`,
    writes the new state back into ``tables`` in place and returns the hit
    count, int32 [1] on the state's device."""
    from repro_torch.core import cache as cache_mod   # core imports ops
    host = cache_mod.HostCache(cache_mod.CacheState(
        policy, **dict(zip(cache_mod.TABLES, tables))))
    if traces is not None:
        n_hit = host.replay_rows(traces.tolist())
    else:
        ks = ([kind] * pages.shape[0] if kinds is None else kinds.tolist())
        n_hit = host.run(pages.tolist(), ks)
    new = host.state()
    for t, name in zip(tables, cache_mod.TABLES):
        t.copy_(getattr(new, name))
    return torch.tensor([n_hit], dtype=torch.int32, device=tables[0].device)
