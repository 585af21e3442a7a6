"""The NAVIS engine, build and search-fan-out side (port of
``repro/core/engine.py``).

``Engine(preset("navis", dim=768)).build(key, vectors)`` builds the index;
``search_many(state, queries)`` runs a wave of queries against one
snapshot of the state and replays their page traces into the shared cache
in query order — the paper's model of concurrent readers sharing one host
cache.  A wave is batch-first: one lane per query through the entrance
search, the on-disk traversal and CASR.

This slice ports the ``navis`` preset's path (decoupled layout, CASR
rerank, in-place updates).  The sequential ``search`` / ``search_batch``,
the packed and full-rerank presets, the buffered path, inserts, deletes
and maintenance come in later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from repro_torch import random as jr
from repro_torch.core import cache as cache_mod
from repro_torch.core import casr as casr_mod
from repro_torch.core import entrance as ent_mod
from repro_torch.core import graph as graph_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core.iomodel import IOCounters, merge_counters, \
    sum_counters
from repro_torch.core.layout import GraphStore, LayoutSpec
from repro_torch.device import resolve_device

INF = 3.4e38


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static engine configuration (the reference's fields and defaults)."""

    dim: int
    r: int = 96
    n_max: int = 0
    pq_m: int = 32
    layout: str = "decoupled"
    rerank: str = "casr"
    entrance: str = "dynamic"
    cache_policy: str = "navis"
    update_path: str = "inplace"
    e_search: int = 40
    e_pos: int = 100
    k: int = 10
    beam_width: int = 4
    max_hops: int = 256
    visited_impl: str = "hash"
    s_search: int = 4
    s_pos: int = 8
    cache_capacity_pages: int = 1024
    ent_frac: float = 0.01
    r_ent: int = 32
    n_entry: int = 10
    ent_pool: int = 32
    buffer_frac: float = 0.06
    buffer_max: int = 4096
    consolidate_frac: float = 0.2
    maint_block: int = 256
    maint_refine: bool = True

    @property
    def lspec(self) -> LayoutSpec:
        return LayoutSpec(kind=self.layout, dim=self.dim, r=self.r)

    def with_(self, **kw) -> "EngineSpec":
        return dataclasses.replace(self, **kw)


PRESETS = {
    "freshdiskann": dict(layout="packed", rerank="full", entrance="static",
                         cache_policy="none", update_path="buffered"),
    "odinann": dict(layout="packed", rerank="full", entrance="static",
                    cache_policy="none", update_path="inplace"),
    "odinann_cache": dict(layout="packed", rerank="full", entrance="static",
                          cache_policy="navis", update_path="inplace"),
    "layout_only": dict(layout="decoupled", rerank="full", entrance="static",
                        cache_policy="none", update_path="inplace"),
    "sel_vec": dict(layout="decoupled", rerank="casr", entrance="static",
                    cache_policy="none", update_path="inplace"),
    "navis": dict(layout="decoupled", rerank="casr", entrance="dynamic",
                  cache_policy="navis", update_path="inplace"),
}


def preset(name: str, dim: int, **overrides) -> EngineSpec:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return EngineSpec(dim=dim, **kw)


@dataclasses.dataclass
class EngineState:
    store: GraphStore
    codes: torch.Tensor              # [N_max, M] uint8
    ent: ent_mod.EntranceGraph
    cache: cache_mod.CacheState
    tombstone: torch.Tensor          # [N_max] bool
    default_entries: torch.Tensor    # [n_entry] int32
    ctr_search: IOCounters
    ctr_insert: IOCounters
    buf_vecs: torch.Tensor           # [B_max, D]
    buf_count: int
    n_deleted: int
    free_list: torch.Tensor          # [N_max] int32
    free_count: int
    free_mask: torch.Tensor          # [N_max] bool
    maint_cursor: int
    young_mask: torch.Tensor         # [N_max] bool
    ctr_maint: IOCounters

    @property
    def live_count(self) -> int:
        return self.store.count - self.n_deleted

    @property
    def live_mask(self) -> torch.Tensor:
        ar = torch.arange(self.store.n_max, device=self.tombstone.device)
        return (ar < self.store.count) & ~self.tombstone


class OpStats(NamedTuple):
    """Per-operation I/O summary, one entry per lane."""
    read_requests: torch.Tensor
    read_bytes: torch.Tensor
    write_requests: torch.Tensor
    write_bytes: torch.Tensor
    serial_rounds: torch.Tensor
    cache_hits: torch.Tensor
    cache_misses: torch.Tensor
    dropped: torch.Tensor


def _sync(t: torch.Tensor) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU), so
    a host clock around a stage measures the stage."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _delta_stats(before: IOCounters, after: IOCounters,
                 rounds: torch.Tensor) -> OpStats:
    """Per-lane I/O of an operation that is never dropped (a search)."""
    dropped = torch.zeros(rounds.shape, dtype=torch.bool,
                          device=rounds.device)
    return OpStats(
        read_requests=after.read_requests - before.read_requests,
        read_bytes=after.total_read_bytes() - before.total_read_bytes(),
        write_requests=after.write_requests - before.write_requests,
        write_bytes=after.total_write_bytes() - before.total_write_bytes(),
        serial_rounds=rounds,
        cache_hits=after.cache_hits - before.cache_hits,
        cache_misses=after.cache_misses - before.cache_misses,
        dropped=dropped)


class Engine:
    """Build once, then run query waves with :meth:`search_many`."""

    def __init__(self, spec: EngineSpec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.codec: Optional[pq_mod.PQCodec] = None
        self._sym: Optional[torch.Tensor] = None
        # host-clock seconds of the last wave: traversal + rerank on the
        # device (until its traces reach the host; the CASR stage alone,
        # between two syncs, in casr_s), then the cache replay
        self.last_wave_timing: dict = {}
        self.last_casr_s = 0.0

    def set_codec(self, codec: pq_mod.PQCodec) -> None:
        self.codec = codec
        self._sym = pq_mod.sym_tables(codec)

    # -- construction -------------------------------------------------------

    def build(self, key: torch.Tensor, base_vectors: torch.Tensor, *,
              build_block: int = 64, build_e_pos: int = 64,
              alpha: float = 1.2, progress=None) -> EngineState:
        """Build the base index over ``base_vectors`` [N, D] (fresh build;
        adopting a ``shared`` bundle comes with a later slice)."""
        spec = self.spec
        dev = self.device
        base_vectors = base_vectors.to(dev, torch.float32)
        n_base, dim = base_vectors.shape
        if dim != spec.dim:
            raise ValueError(f"vectors have dim {dim}, the spec {spec.dim}")
        n_max = spec.n_max or n_base
        k_pq, k_ent, k_build = jr.split(key.cpu(), 3)
        if self.codec is None:
            pick = jr.choice(k_pq, n_base, (min(n_base, 4096),),
                             replace=False).to(dev)
            self.codec = pq_mod.train_pq(k_pq, base_vectors[pick], spec.pq_m)
        self._sym = pq_mod.sym_tables(self.codec)
        codes = torch.zeros((n_max, spec.pq_m), dtype=torch.uint8,
                            device=dev)
        codes[:n_base] = pq_mod.encode(self.codec, base_vectors)
        padded = torch.zeros((n_max, dim), device=dev)
        padded[:n_base] = base_vectors
        store = graph_mod.build_graph(
            k_build, padded, n_base, spec.lspec, self.codec, codes,
            n_max=n_max, e_pos=build_e_pos, block=build_block, alpha=alpha,
            progress=progress)

        c_max = max(int(spec.ent_frac * n_max * 2), 64)
        if spec.entrance == "none":
            ent = ent_mod.empty_entrance(c_max, spec.r_ent, n_max, dev)
        else:
            ent = ent_mod.build_entrance(
                k_ent, codes, self._sym, n_base, c_max=c_max,
                r_ent=spec.r_ent, sample_frac=spec.ent_frac, n_max=n_max)
        cache = cache_mod.init_cache(
            store.p_max, spec.cache_capacity_pages, spec.cache_policy,
            jr.fold_in(key.cpu(), 7), device=dev)
        med = graph_mod.medoid(base_vectors, n_base)
        default_entries = torch.cat([
            torch.tensor([med]), jr.choice(jr.fold_in(key.cpu(), 9), n_base,
                                           (spec.n_entry - 1,))
        ]).to(dev, torch.int32)
        zeros = lambda: IOCounters.zeros((), dev)
        return EngineState(
            store=store, codes=codes, ent=ent, cache=cache,
            tombstone=torch.zeros((n_max,), dtype=torch.bool, device=dev),
            default_entries=default_entries,
            ctr_search=zeros(), ctr_insert=zeros(),
            buf_vecs=torch.zeros((spec.buffer_max, dim), device=dev),
            buf_count=0, n_deleted=0,
            free_list=torch.full((n_max,), -1, dtype=torch.int32,
                                 device=dev),
            free_count=0,
            free_mask=torch.zeros((n_max,), dtype=torch.bool, device=dev),
            maint_cursor=0,
            young_mask=torch.zeros((n_max,), dtype=torch.bool, device=dev),
            ctr_maint=zeros())

    # -- entry-point selection ----------------------------------------------

    def _entries(self, state: EngineState, lut: torch.Tensor):
        """① entry selection per lane -> (entry_ids [B, n_entry],
        e_ent [B, ent_pool])."""
        spec = self.spec
        b = lut.shape[0]
        if spec.entrance == "none" or state.ent.count <= 0:
            return (state.default_entries[None].expand(b, -1),
                    torch.full((b, spec.ent_pool), -1, dtype=torch.int32,
                               device=lut.device))
        entries, e_ent, _ = search_mod.entrance_search(
            state.ent, lut, state.codes, n_entry=spec.n_entry,
            pool_size=spec.ent_pool)
        return entries, e_ent

    # -- search --------------------------------------------------------------

    def _check_sliced(self) -> None:
        spec = self.spec
        if (spec.layout, spec.rerank, spec.update_path,
                spec.visited_impl) != ("decoupled", "casr", "inplace",
                                       "hash"):
            raise NotImplementedError(
                "this port runs the decoupled + CASR + in-place path with "
                "hashed visited sets; the other presets come later")

    def _search_core(self, state: EngineState, qs: torch.Tensor):
        """A wave of searches against a frozen snapshot: traverse + CASR.
        Returns (ids, dists, stats, counters, traverse result), one lane
        per query."""
        spec = self.spec
        b = qs.shape[0]
        ctr0 = IOCounters.zeros((b,), qs.device)
        lut = pq_mod.adc_lut(self.codec, qs)
        entries, _ = self._entries(state, lut)
        res = search_mod.disk_traverse(
            state.store, spec.lspec, lut, state.codes, state.cache, ctr0,
            entries, pool_size=spec.e_search, beam_width=spec.beam_width,
            max_hops=spec.max_hops)
        ctr = res.counters
        dead = (res.pool_ids >= 0) & \
            state.tombstone[res.pool_ids.clamp(min=0).long()]
        ctr = dataclasses.replace(
            ctr, tombstone_skips=ctr.tombstone_skips + dead.sum(1))
        pool = torch.where(dead, -1, res.pool_ids)
        _sync(qs)
        t0 = time.perf_counter()
        cres = casr_mod.casr_rerank(state.store, spec.lspec, qs, pool, ctr,
                                    k=spec.k, s=spec.s_search)
        _sync(qs)
        self.last_casr_s = time.perf_counter() - t0
        rounds = res.hops + cres.rerank_rounds
        stats = _delta_stats(ctr0, cres.counters, rounds)
        return cres.topk_ids, cres.topk_d, stats, cres.counters, res

    def search_many(self, state: EngineState, queries: torch.Tensor):
        """Batch-parallel search fan-out: the whole wave runs against one
        snapshot, then the traces replay in query order into the shared
        cache and the per-query counters add up.  Returns (ids [Q, k],
        dists [Q, k], per-query OpStats, new state)."""
        self._check_sliced()
        qs = queries.to(self.device, torch.float32)
        t0 = time.perf_counter()
        ids, dists, stats, ctrs, res = self._search_core(state, qs)
        traces = res.trace.cpu()          # waits for the wave to finish
        t1 = time.perf_counter()
        _, cache = cache_mod.apply_traces(state.cache, traces)
        self.last_wave_timing = {"wave_s": t1 - t0,
                                 "casr_s": self.last_casr_s,
                                 "replay_s": time.perf_counter() - t1}
        state = dataclasses.replace(
            state, cache=cache,
            ctr_search=merge_counters(state.ctr_search, sum_counters(ctrs)))
        return ids, dists, stats, state
