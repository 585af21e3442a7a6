"""Search by closed-loop clients.

``clients`` clients each issue a query, wait for its answer, think for an
exponential time of mean ``think_s``, and issue again.  Whenever the
engine is free it serves every outstanding query, at most ``wave_cap``,
as one ``Engine.search_many`` wave; when none is outstanding it waits for
the next issue.  Each query is timed from its issue to the end of the
wave that answers it, so throughput and tail both move with wave time.

Queries are rows of a pool drawn in set-up, taken in issue order; the
clients' first issues and think times are drawn from the seed.  Clients
stop issuing once ``seconds`` have passed.  The window ends with the wave
that is running then (or at ``seconds``, if the engine is waiting);
queries issued before ``seconds`` and not yet answered are served after
it, in the drain, and their latencies count.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from navisbench import cell as cell_mod
from navisbench import corpus
from navisbench.cache_watch import CacheWatch
from navisbench.harness import Span


def setup(cell) -> dict:
    mix = cell.mix
    pool = corpus.draw(cell.gen, cell.mixture, mix["query_pool"])
    for _ in range(mix["warmup_waves"]):
        # the warm-up's states are thrown away
        cell.engine.search_many(cell.state, pool[:mix["wave_cap"]])
    cell_mod.sync(cell.device)
    return {"pool": pool}


def window(cell, data: dict, rec) -> cell_mod.Outputs:
    mix = cell.mix
    pool = data["pool"]
    n_pool = pool.shape[0]
    n_clients, think, cap = mix["clients"], mix["think_s"], mix["wave_cap"]
    rng = np.random.default_rng(cell.seed)
    ctr0 = cell_mod.counters(cell.state)
    watch = CacheWatch(cell.state.cache, cell.seed + 2,
                       mix["cache_sample"]).open()
    start = time.perf_counter()
    stop = start + cell.seconds
    next_issue = start + rng.exponential(think, n_clients)
    issued, answered, ids, dists, rows = [], [], [], [], []
    n_issued = 0
    window_end = None
    while True:
        now = time.perf_counter()
        if window_end is None and now >= stop:
            window_end = stop
        due = np.nonzero(next_issue <= min(now, stop))[0]
        if due.size == 0:
            later = next_issue[next_issue <= stop]
            if later.size == 0:
                break
            wait = float(later.min()) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
                rec.spans.append(Span("clients.waiting", now,
                                      time.perf_counter()))
            continue
        # the earliest issues first, ties by client
        due = due[np.lexsort((due, next_issue[due]))][:cap]
        q_rows = (n_issued + np.arange(due.size)) % n_pool
        n_issued += due.size
        cell.tracer.boundary(time.perf_counter() - start, rec.spans)
        i, d, t0, t1 = cell_mod.search_op(
            cell, rec, pool[torch.from_numpy(q_rows).to(cell.device)],
            "search_many")
        issued.append(next_issue[due])
        answered.append(np.full(due.size, t1))
        ids.append(i)
        dists.append(d)
        rows.append(q_rows)
        if window_end is None and t1 >= stop:
            window_end = t1
        next_issue[due] = t1 + rng.exponential(think, due.size)
    cell.tracer.stop(rec.spans)
    window_end = window_end or time.perf_counter()
    cache = watch.close(cell.state.cache,
                        [op["cache_hits"] for op in rec.ops_of("search")])
    cache["policy"] = cell.engine.spec.cache_policy
    issued, answered = np.concatenate(issued), np.concatenate(answered)
    rec.window_s = window_end - start
    rec.latencies_s = answered - issued
    rec.n_answered = int((answered <= window_end).sum())
    rec.attempted = int(issued.size)
    rec.counters = cell_mod.counter_delta(ctr0, cell_mod.counters(cell.state))
    n = issued.size
    recall_rows = torch.from_numpy(np.sort(np.random.default_rng(
        cell.seed + 1).permutation(n)[:mix["recall_sample"]]))
    return cell_mod.Outputs(
        pool=pool,
        query_rows=torch.from_numpy(np.concatenate(rows)).to(cell.device),
        ids=torch.cat(ids), dists=torch.cat(dists),
        recall_rows=recall_rows, base=cell.base, cache=cache)
