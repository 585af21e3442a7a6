"""The comparison that decides ``correct``, and recall@10.

Every answer the window produced (and the drain after it) is judged, and
the page cache that the window's searches replayed into:

- ``bad_answers``: queries whose answer is not a valid top k: an id
  outside the corpus, a repeated id, a distance that is not finite, or
  distances out of order.  Exact: 0.
- ``dist_err``: the widest relative gap between a returned distance and
  the reference's exact squared L2 (float64) from the query to the id
  returned.  It holds the rerank's exact-L2 distances and the ids they
  belong to.
- ``missed_at_10``: the share of the reference's exact top 10 missing
  from the answers sampled from the seed (1 - recall@10).  It holds the
  traversal, which finds the candidates that the rerank orders.
- ``cache_replay_diff``: on the waves sampled from the seed, the entries
  of the program's cache after the wave that differ from the reference's
  replay of the wave's traces from the program's cache before it, plus
  the gap between the hits the program counted in the wave and the
  charged pages that cache held.  Exact: 0.
- ``cache_chain_breaks``: waves whose cache is not the one the wave
  before left (``navisbench/cache_watch.py``).  Exact: 0.

recall@10 (an end-to-end metric) is ``1 - missed_at_10``.
"""
from __future__ import annotations

import torch

from navisbench.reference import cache as ref_cache
from navisbench.reference import exact


def answer_numbers(out) -> dict:
    """``bad_answers`` and ``dist_err`` over every answer in ``out``."""
    corpus = out.base
    q = out.pool[out.query_rows]
    ids = out.ids.to(corpus.device).long()
    d = out.dists.to(corpus.device).to(torch.float64)
    valid = (ids >= 0) & (ids < corpus.shape[0])
    srt = ids.sort(1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    bad = (~valid).any(1) | dup | ~torch.isfinite(d).all(1) | \
        (d[:, 1:] < d[:, :-1]).any(1)
    ref = exact.pair_dist(q, corpus, torch.where(valid, ids, -1))
    rel = (d - ref).abs() / ref.clamp(min=torch.finfo(torch.float64).tiny)
    rel = rel[valid & torch.isfinite(rel)]
    return {"bad_answers": int(bad.sum()),
            "dist_err": float(rel.max()) if rel.numel() else 0.0}


def missed(out, k: int) -> float:
    """The share of the exact top k missing from the sampled answers."""
    rows = out.recall_rows.to(out.ids.device)
    q = out.pool[out.query_rows[rows]]
    truth, _ = exact.topk(q, out.base, k)
    got = out.ids[rows].to(truth.device).long()
    hits = (got[:, :, None] == truth[:, None, :]).any(2)
    return 1.0 - float(hits.double().mean())


def cache_numbers(watched: dict) -> dict:
    """``cache_replay_diff`` and ``cache_chain_breaks`` of a window."""
    if watched["policy"] != "navis":
        raise NotImplementedError(
            f"no reference of the {watched['policy']!r} cache policy")
    diff = 0
    for w in watched["sampled"]:
        want = ref_cache.replay(w["before"], w["traces"])
        diff += ref_cache.differences(w["after"], want)
        diff += abs(w["hits"] -
                    ref_cache.snapshot_hits(w["before"], w["traces"]))
    return {"cache_replay_diff": diff,
            "cache_chain_breaks": watched["breaks"]}


def judge(out, limits: dict, k: int):
    """(numbers {name: {"value", "limit"}}, correct, recall@k)."""
    values = answer_numbers(out)
    values["missed_at_10"] = missed(out, k)
    values.update(cache_numbers(out.cache))
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing} in the cell's checks file")
    numbers = {n: {"value": v, "limit": limits[n]} for n, v in values.items()}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    return numbers, correct, 1.0 - values["missed_at_10"]
