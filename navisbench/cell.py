"""A cell's set-up, shared by the driver loops: the corpus from the seed,
the port's engine built over it, and what the window's answers are
judged by afterwards.

The system under test is ``repro_torch.core.Engine``; nothing else of the
port is called here.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from navisbench import corpus
from navisbench.harness import Span


@dataclasses.dataclass
class Cell:
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: torch.device
    gen: torch.Generator        # the traffic's, from the run's seed
    mixture: corpus.Mixture
    base: torch.Tensor          # [n_base, D] the corpus the index is built on
    engine: object
    state: object
    build_s: float
    tracer: object              # navisbench.tracing.Tracer


@dataclasses.dataclass
class Outputs:
    """What the timed path produced, copied out of the program's state so
    that the state can be freed before the reference runs.

    ``ids`` / ``dists`` [Q, k]: every answer of the window (and of the
    drain after it), in issue order; ``query_rows`` [Q]: each query's row
    in ``pool``; ``recall_rows``: the answers sampled from the seed for
    recall@10; ``base``: the corpus the index was built on; ``cache``:
    what the window's waves did to the page cache
    (:meth:`navisbench.cache_watch.CacheWatch.close`)."""
    pool: torch.Tensor
    query_rows: torch.Tensor
    ids: torch.Tensor
    dists: torch.Tensor
    recall_rows: torch.Tensor
    base: torch.Tensor
    cache: dict


def engine_spec(cfg: dict):
    from repro_torch.core import preset
    return preset(cfg["preset"], dim=cfg["dim"], r=cfg["r"],
                  n_max=cfg["n_base"] + cfg["headroom"], pq_m=cfg["pq_m"],
                  e_search=cfg["e_search"], e_pos=cfg["e_pos"], k=cfg["k"],
                  beam_width=cfg["beam_width"], max_hops=cfg["max_hops"],
                  cache_capacity_pages=cfg["cache_capacity_pages"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: dict, mix: dict, seed: int, seconds: float, device,
          tracer) -> Cell:
    """Draw the configuration's data set on ``device`` and build the
    engine over it (``build_s``: the host clock around the build, ended
    by a sync); the cell's generator for its traffic is seeded from
    ``seed``.

    The data set (the mixture, the base corpus and the build's key) comes
    from the configuration's ``corpus.seed``, the same in every run, as a
    deployment serves one index: indexes drawn from other data sets
    differ in recall@10 and in queries a second by more than runs of one
    index do, so a run on a fresh data set would judge the program by
    the draw.  Every seed serves the same index with its own queries and
    arrivals."""
    from repro_torch import random as jr
    from repro_torch.core import Engine
    device = torch.device(device)
    data = corpus.generator(cfg["corpus"]["seed"], device)
    mixture = corpus.mixture(data, cfg["corpus"], cfg["dim"])
    base = corpus.draw(data, mixture, cfg["n_base"])
    eng = Engine(engine_spec(cfg), device=device)
    sync(device)
    t0 = time.perf_counter()
    state = eng.build(jr.PRNGKey(cfg["corpus"]["seed"]), base,
                      build_block=cfg["build_block"],
                      build_e_pos=cfg["build_e_pos"])
    sync(device)
    return Cell(cfg=cfg, mix=mix, seed=seed, seconds=seconds, device=device,
                gen=corpus.generator(seed, device), mixture=mixture,
                base=base, engine=eng, state=state,
                build_s=time.perf_counter() - t0, tracer=tracer)


def counters(state) -> dict:
    """The engine's search and insert I/O counters as host integers."""
    return {name: {f.name: int(getattr(ctr, f.name))
                   for f in dataclasses.fields(ctr)}
            for name, ctr in (("search", state.ctr_search),
                              ("insert", state.ctr_insert))}


def counter_delta(before: dict, after: dict) -> dict:
    return {name: {f: after[name][f] - before[name][f] for f in after[name]}
            for name in after}


def search_op(cell: Cell, rec, queries: torch.Tensor, span_name: str):
    """One ``search_many`` wave on the cell's state, its host span, its
    stage spans and its cache hits (a device scalar) recorded.  Returns
    (ids, dists, t0, t1)."""
    eng = cell.engine
    t0 = time.perf_counter()
    ids, dists, stats, cell.state = eng.search_many(cell.state, queries)
    hits = stats.cache_hits.sum()
    sync(cell.device)
    t1 = time.perf_counter()
    tm = dict(eng.last_wave_timing)
    rec.ops.append({"kind": "search", "n": int(queries.shape[0]),
                    "t0": t0, "t1": t1, "timing": tm, "cache_hits": hits})
    traverse = tm["wave_s"] - tm["rerank_s"]
    rec.spans += [
        Span(f"{span_name}.traverse", t0, t0 + traverse),
        Span(f"{span_name}.rerank", t0 + traverse, t0 + tm["wave_s"]),
        Span(f"{span_name}.replay", t0 + tm["wave_s"],
             t0 + tm["wave_s"] + tm["replay_s"]),
        Span(f"{span_name}.rest", t0 + tm["wave_s"] + tm["replay_s"], t1)]
    return ids, dists, t0, t1
