"""The NAVIS engine (port of ``repro/core/engine.py``): one engine, and
every paper baseline a configuration of it.

=================  =========  ======  ========  ==============  ===========
system             layout     rerank  entrance  cache           update path
=================  =========  ======  ========  ==============  ===========
freshdiskann       packed     full    static    none            buffered
odinann            packed     full    static    none            inplace
odinann_cache      packed     full    static    navis (packed)  inplace
layout_only        decoupled  full    static    none            inplace
sel_vec            decoupled  casr    static    none            inplace
navis              decoupled  casr    dynamic   navis           inplace
=================  =========  ======  ========  ==============  ===========

``Engine(preset(name, dim=768)).build(key, vectors)`` builds the index;
``build(key, vectors, shared=other.bundle(state))`` adopts another
engine's graph and re-pages it for this engine's layout.  Then, as in
the reference:

- ``search_many(state, queries)`` runs a wave of queries against one
  snapshot and replays their page traces into the shared cache in query
  order — the paper's model of concurrent readers sharing one host cache.
- ``insert_many(state, vectors)`` position-seeks a whole insert wave
  against one snapshot (phase ①, one lane per insert), replays the seeks'
  traces, then commits the inserts one after another with the
  conflict-aware checks of the reference's scan (phase ②): re-validated
  picks, RMW re-reads of pages the wave dirtied, free-list slots first,
  NAVIS-update of the entrance graph and the entrance-aware cache admit.
- ``search`` / ``search_batch`` and ``insert`` / ``insert_batch`` are the
  sequential paths: one operation after another, each traversal threaded
  through the cache page by page.
- ``delete`` / ``delete_many`` tombstone ids and scrub dropped entrance
  members' reciprocal edges.
- The buffered path (FreshDiskANN) appends inserts to an in-memory
  buffer with no I/O; searches merge exact buffer hits (virtual ids
  ``n_max + slot``); ``merge`` inserts the buffered vectors in place, one
  after another through one shared page buffer, then charges the
  stream rewrite of the whole index.  ``needs_merge`` says when.
- The full-rerank baselines rerank every pool candidate and move the
  useful share of their vector bytes, by the CASR classifier, from
  wasted to useful (Fig. 4a).  ``calibrate`` sets the CASR group sizes
  from warm-up queries.

- ``needs_consolidation``, ``maintenance_step`` and ``consolidate`` run
  the maintenance pass (``core/maintenance.py``): repair blocks of
  ``maint_block`` rows, then refine, reclaim into the free list, defrag
  and the entrance refresh.

Every operation leaves its input state untouched and returns a new one:
it copies the tensors it mutates once per call, then writes them in
place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import spans
from repro_torch.core import cache as cache_mod
from repro_torch.core import casr as casr_mod
from repro_torch.core import entrance as ent_mod
from repro_torch.core import graph as graph_mod
from repro_torch.core import insert as insert_mod
from repro_torch.core import layout as layout_mod
from repro_torch.core import maintenance as maint_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core.iomodel import IOCounters, PAGE_BYTES, \
    merge_counters, sum_counters
from repro_torch.core.layout import GraphStore, LayoutSpec, \
    assign_initial_pages
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

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


WAVE_COUNTS = ("entry_iters", "traverse_iters", "traverse_lanes",
               "visited_redo")


def _wave_timing(rec: dict) -> dict:
    """``search_many``'s ``last_wave_timing`` from its record
    (:func:`spans.take`): ``wave_s`` from the root's start to the sync
    after the traversal and rerank (where the replay starts), the
    ``rerank`` and ``replay`` spans' seconds, and the record's ``spans``,
    ``reads`` and ``counts`` (:data:`WAVE_COUNTS`, 0 where none ran)."""
    at = {s.name: s for s in rec["spans"]}
    return {"wave_s": at["replay"].t0 - at["search_many"].t0,
            "rerank_s": at["rerank"].seconds,
            "replay_s": at["replay"].seconds,
            "spans": rec["spans"], "reads": rec["reads"],
            "counts": {k: rec["counts"].get(k, 0) for k in WAVE_COUNTS}}


def _delta_stats(before: IOCounters, after: IOCounters,
                 rounds: torch.Tensor,
                 dropped: torch.Tensor | None = None) -> OpStats:
    """Per-lane I/O of an operation (``dropped`` False by default)."""
    if dropped is None:
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


def _zero_stats(dropped: torch.Tensor) -> OpStats:
    """The stats of operations that did no I/O (buffered appends, skipped
    lanes), shaped like ``dropped``."""
    z = torch.zeros(dropped.shape, dtype=torch.int64, device=dropped.device)
    return OpStats(z, z, z, z, z.to(torch.int32), z, z, dropped)


def _stack_stats(stats: list[OpStats]) -> OpStats:
    return OpStats(*[torch.stack(f) for f in zip(*stats)])


def _join_counters(ctrs: list[IOCounters], join) -> IOCounters:
    """Per-op counters joined field by field (``torch.stack`` of scalars
    or ``torch.cat`` of lanes) into one lane dimension."""
    return IOCounters(*[join([getattr(c, f.name) for c in ctrs])
                        for f in dataclasses.fields(IOCounters)])


def _owned(state: EngineState) -> EngineState:
    """A copy of ``state`` whose graph, codes, entrance and slot tables an
    operation may write in place (counters and the cache are rebuilt, not
    written)."""
    st, ent = state.store, state.ent
    store = dataclasses.replace(st, **{f: getattr(st, f).clone() for f in (
        "edges", "degree", "vectors", "edge_page", "page_live")})
    ent = dataclasses.replace(ent, ids=ent.ids.clone(),
                              edges=ent.edges.clone(),
                              main_to_ent=ent.main_to_ent.clone())
    return dataclasses.replace(
        state, store=store, codes=state.codes.clone(), ent=ent,
        tombstone=state.tombstone.clone(), free_list=state.free_list.clone(),
        free_mask=state.free_mask.clone(),
        young_mask=state.young_mask.clone())


class Engine:
    """Build once, then thread :class:`EngineState` through ``search*``,
    ``insert*`` and ``delete*``."""

    def __init__(self, spec: EngineSpec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.codec: Optional[pq_mod.PQCodec] = None
        self._sym: Optional[torch.Tensor] = None
        # host-clock seconds of the last wave from its spans
        # (:mod:`repro_torch.spans`), each stage ended by a sync.
        # search_many: wave_s, traversal + rerank on the device (the
        # rerank stage alone, classifier included, in rerank_s), then
        # replay_s, the cache replay; and the wave's spans, host reads
        # and loop counts (:func:`_wave_timing`).  insert_many: seek_s
        # (phase ①), replay_s, commit_s (phase ②, the cache packed);
        # append_s on the buffered path
        self.last_wave_timing: dict = {}
        # insert_many: RMW re-reads charged, entrance promotions and
        # priority admits of the last wave
        self.last_wave_counts: dict = {}
        # consolidate: repair_s (the sweep), then the finalization's
        # refine_s (refine_blocks of 32), reclaim_defrag_s and refresh_s
        self.last_maint_timing: dict = {}

    def set_codec(self, codec: pq_mod.PQCodec) -> None:
        self.codec = codec
        self._sym = pq_mod.sym_tables(codec)

    # -- construction -------------------------------------------------------

    def build(self, key: torch.Tensor, base_vectors: torch.Tensor, *,
              build_block: int = 64, build_e_pos: int = 64,
              alpha: float = 1.2, progress=None,
              shared=None) -> EngineState:
        """Build the base index over ``base_vectors`` [N, D], or adopt
        ``shared``, a ``(codec, codes, store)`` bundle from another
        engine's build on this device (:meth:`bundle`): the graph does not
        depend on the layout, so sweeps build it once and re-page it for
        each engine (``layout.assign_initial_pages``)."""
        spec = self.spec
        dev = self.device
        base_vectors = base_vectors.to(dev, torch.float32)
        n_base, dim = base_vectors.shape
        if dim != spec.dim:
            raise ValueError(f"vectors have dim {dim}, the spec {spec.dim}")
        n_max = spec.n_max or n_base
        k_pq, k_ent, k_build = jr.split(key.cpu(), 3)
        if shared is not None:
            self.codec, codes, store = shared
            self._sym = pq_mod.sym_tables(self.codec)
            store = assign_initial_pages(store, spec.lspec)
        else:
            if self.codec is None:
                pick = jr.choice(k_pq, n_base, (min(n_base, 4096),),
                                 replace=False).to(dev)
                self.codec = pq_mod.train_pq(k_pq, base_vectors[pick],
                                             spec.pq_m)
            self._sym = pq_mod.sym_tables(self.codec)
            codes = torch.zeros((n_max, spec.pq_m), dtype=torch.uint8,
                                device=dev)
            codes[:n_base] = pq_mod.encode(self.codec, base_vectors)
            padded = torch.zeros((n_max, dim), device=dev)
            padded[:n_base] = base_vectors
            store = graph_mod.build_graph(
                k_build, padded, n_base, spec.lspec, self.codec, codes,
                n_max=n_max, e_pos=build_e_pos, block=build_block,
                alpha=alpha, progress=progress)

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

    def bundle(self, state: EngineState):
        """(codec, codes, store): what another engine's ``build(shared=)``
        adopts."""
        return (self.codec, state.codes, state.store)

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
            pool_size=spec.ent_pool, visited=spec.visited_impl)
        return entries, e_ent

    # -- classification (Fig 4a) --------------------------------------------

    def _reclassify(self, counters: IOCounters, qs: torch.Tensor,
                    pool_ids: torch.Tensor, store: GraphStore
                    ) -> IOCounters:
        """Move the CASR classifier's useful share of each lane's
        provisionally wasted vector bytes into the useful bucket (packed
        piggybacking and the decoupled full rerank both charge them as
        wasted): the s = 1 stop point of the lane's pool [B, P], at most
        its valid count, times the vector size, at most what was charged
        wasted.  One ``casr_rerank`` launch a wave."""
        spec = self.spec
        n_useful = casr_mod.casr_stop_point(qs, store.vectors, pool_ids,
                                            k=spec.k, s=1)
        n_useful = torch.minimum(n_useful, (pool_ids >= 0).sum(1))
        moved = torch.minimum(n_useful * spec.lspec.vector_bytes,
                              counters.wasted_vec_bytes_read)
        return dataclasses.replace(
            counters,
            useful_vec_bytes_read=counters.useful_vec_bytes_read + moved,
            wasted_vec_bytes_read=counters.wasted_vec_bytes_read - moved)

    # -- search --------------------------------------------------------------

    def _search_core(self, state: EngineState, qs: torch.Tensor,
                     cache=None):
        """Traverse + rerank (+ the buffer's hits), one lane per query: a
        wave against the frozen snapshot ``state.cache``, or one query
        threaded through ``cache`` (a handle, :func:`cache.open`).  Returns
        (ids, dists, stats, counters, traverse result)."""
        spec = self.spec
        b = qs.shape[0]
        ctr0 = IOCounters.zeros((b,), qs.device)
        with spans.span("lut"):
            lut = pq_mod.adc_lut(self.codec, qs)
        with spans.span("entry"):
            entries, _ = self._entries(state, lut)
        with spans.span("traverse"):
            res = search_mod.disk_traverse(
                state.store, spec.lspec, lut, state.codes,
                state.cache if cache is None else cache, ctr0,
                entries, pool_size=spec.e_search, beam_width=spec.beam_width,
                max_hops=spec.max_hops, visited=spec.visited_impl)
        with spans.span("mask"):
            ctr = res.counters
            dead = (res.pool_ids >= 0) & \
                state.tombstone[res.pool_ids.clamp(min=0).long()]
            ctr = dataclasses.replace(
                ctr, tombstone_skips=ctr.tombstone_skips + dead.sum(1))
            pool = torch.where(dead, -1, res.pool_ids)
            spans.sync(qs)
        with spans.span("rerank"):
            if spec.rerank == "casr":
                cres = casr_mod.casr_rerank(state.store, spec.lspec, qs,
                                            pool, ctr, k=spec.k,
                                            s=spec.s_search)
                ids, dists, ctr = cres.topk_ids, cres.topk_d, cres.counters
                rounds = res.hops + cres.rerank_rounds
            else:
                ids, dists, _, ctr = search_mod.full_rerank(
                    state.store, spec.lspec, qs, res._replace(pool_ids=pool),
                    ctr, k=spec.k)
                rounds = res.hops + (1 if spec.layout == "packed" else 2)
                ctr = self._reclassify(ctr, qs, pool, state.store)
            spans.sync(qs)
        if spec.update_path == "buffered":
            ids, dists = self._merge_buffer_hits(state, qs, ids, dists)
        stats = _delta_stats(ctr0, ctr, rounds)
        return ids, dists, stats, ctr, res

    def _merge_buffer_hits(self, state: EngineState, qs: torch.Tensor,
                           ids: torch.Tensor, dists: torch.Tensor):
        """FreshDiskANN: merge each lane's exact distances to the buffered
        vectors (no I/O) into its top-k.  Buffer ids are virtual, ``n_max
        + slot``: the vectors are not in the graph yet.  Every lane scores
        the same rows, so the buffer is scored in place in one
        ``rerank_l2_shared`` launch (INF from ``buf_count`` on) and merged
        in chunks that fit the merge kernel."""
        spec = self.spec
        b = qs.shape[0]
        slots = torch.arange(spec.buffer_max, dtype=torch.int32,
                             device=qs.device)
        slots = torch.where(slots < state.buf_count, slots, -1)
        bids = slots[None].expand(b, -1).contiguous()
        bd = kernel_ops.rerank_l2_shared(qs.contiguous(), state.buf_vecs,
                                         state.buf_count)
        d, i = kernel_ops.pool_merge_chunked(
            torch.where(ids >= 0, dists, INF), ids.contiguous(), bd,
            torch.where(bids >= 0, bids + state.store.n_max, -1))
        return torch.where(d < INF, i, -1), d

    def search_many(self, state: EngineState, queries: torch.Tensor):
        """Batch-parallel search fan-out: the whole wave runs against one
        snapshot, then the traces replay in query order into the shared
        cache and the per-query counters add up.  Returns (ids [Q, k],
        dists [Q, k], per-query OpStats, new state)."""
        qs = queries.to(self.device, torch.float32)
        with spans.span("search_many"):
            ids, dists, stats, ctrs, res = self._search_core(state, qs)
            spans.sync(qs)
            with spans.span("replay"):
                _, cache = cache_mod.apply_traces(state.cache, res.trace)
                spans.sync(qs)
        self.last_wave_timing = _wave_timing(spans.take())
        state = dataclasses.replace(
            state, cache=cache,
            ctr_search=merge_counters(state.ctr_search, sum_counters(ctrs)))
        return ids, dists, stats, state

    def search(self, state: EngineState, q: torch.Tensor):
        """One sequential search, its traversal threaded through the cache
        page by page.  Returns (ids [k], dists [k], stats, new state)."""
        ids, dists, stats, state = self.search_batch(state, q[None])
        return ids[0], dists[0], OpStats(*[f[0] for f in stats]), state

    def search_batch(self, state: EngineState, queries: torch.Tensor):
        """Searches one after another, the cache and the search counters
        threaded through them.  Returns (ids [Q, k], dists [Q, k],
        per-query OpStats, new state)."""
        qs = queries.to(self.device, torch.float32)
        cache = cache_mod.open(state.cache)
        ids, dists, stats, ctrs = [], [], [], []
        for i in range(qs.shape[0]):
            out = self._search_core(state, qs[i:i + 1], cache)
            for acc, x in zip((ids, dists, stats, ctrs), out):
                acc.append(x)
        state = dataclasses.replace(
            state, cache=cache.state(),
            ctr_search=merge_counters(state.ctr_search, sum_counters(
                _join_counters(ctrs, torch.cat))))
        return (torch.cat(ids), torch.cat(dists),
                OpStats(*[torch.cat(f) for f in zip(*stats)]), state)

    # -- insert ---------------------------------------------------------------

    def _insert_one(self, st: EngineState, v: torch.Tensor,
                    cache: cache_mod.Handle,
                    page_seen: torch.Tensor | None = None):
        """One sequential in-place insertion (the reference's
        ``_insert_inplace``) into ``st``, which the caller owns (written
        in place; the returned state shares its tensors), its cache
        advanced through the handle ``cache``.  ``page_seen`` [P_max]
        seeds the traversal's page buffer (a merge's shared one).
        Returns (stats, state, page_seen)."""
        spec = self.spec
        dev = self.device
        ctr0 = IOCounters.zeros((), dev)
        # capacity guard: with no free slot left past n_max the insertion
        # is skipped before it reserves a page, and flagged dropped
        if st.store.count >= st.store.n_max and st.free_count <= 0:
            if page_seen is None:
                page_seen = search_mod.empty_page_seen(
                    st.store, visited=spec.visited_impl,
                    max_hops=spec.max_hops, beam_width=spec.beam_width)
            return (_zero_stats(torch.ones((), dtype=torch.bool,
                                           device=dev)), st, page_seen)
        lut = pq_mod.adc_lut(self.codec, v[None])
        entries, e_ent = self._entries(st, lut)
        # reclaimed slots are reused before fresh ones
        reuse = st.free_count > 0
        slot = (int(st.free_list[st.free_count - 1]) if reuse
                else st.store.count)
        new_code = pq_mod.encode(self.codec, v[None])[0]
        st.codes[slot] = new_code
        ires = insert_mod.insert_vertex(
            st.store, spec.lspec, self.codec, st.codes, self._sym, cache,
            ctr0, v, entries[0], e_pos=spec.e_pos, k=spec.k, s=spec.s_pos,
            rerank=spec.rerank, beam_width=spec.beam_width,
            max_hops=spec.max_hops, tombstone=st.tombstone,
            page_seen=page_seen, visited=spec.visited_impl, new_id=slot)
        ctr = ires.counters
        if spec.rerank == "full":
            # the classifier reads the post-commit store, as the reference
            ctr = self._reclassify(
                ctr.map(lambda x: x[None]), v[None], ires.pool_ids[None],
                ires.store).map(lambda x: x[0])
        ent = st.ent
        if spec.entrance == "dynamic":
            count0 = ent.count
            ent = ent_mod.navis_update(
                ent, slot, new_code, ires.pool_ids, e_ent[0],
                ires.store.count, st.codes, self._sym,
                r_ent_frac=spec.ent_frac)
            if spec.cache_policy == "navis" and ent.count > count0:
                # entrance-aware hint (§7): a promoted member's edgelist
                # page seeds future traversals
                cache.priority_admit(ires.store.edge_page[slot])
        stats = _delta_stats(ctr0, ctr, ires.hops + ires.rerank_rounds)
        st.tombstone[slot] = False
        st.free_mask[slot] = False
        st.young_mask[slot] = True
        st = dataclasses.replace(
            st, store=ires.store, ent=ent,
            n_deleted=st.n_deleted - reuse, free_count=st.free_count - reuse,
            ctr_insert=merge_counters(st.ctr_insert, ctr))
        return stats, st, ires.page_seen

    def _append_buffer(self, state: EngineState, vs: torch.Tensor,
                       keep: list[bool]):
        """FreshDiskANN's insert: append the kept vectors of ``vs`` [B, D]
        to the in-memory buffer, in order, with no storage I/O; past the
        buffer's capacity a vector is dropped.  Returns (per-insert
        OpStats [B], new state); ``needs_merge`` says when to merge."""
        cap = self.spec.buffer_max
        count, lanes, dropped = state.buf_count, [], []
        for i, k in enumerate(keep):
            dropped.append(k and count >= cap)
            if k and count < cap:
                lanes.append(i)
                count += 1
        buf = state.buf_vecs
        if lanes:
            buf = buf.clone()
            buf[state.buf_count:count] = vs[lanes]
        stats = _zero_stats(torch.tensor(dropped, device=self.device))
        return stats, dataclasses.replace(state, buf_vecs=buf,
                                          buf_count=count)

    def insert(self, state: EngineState, v: torch.Tensor):
        """One sequential insertion.  Returns (stats, new state,
        page_seen: the pages its traversal read; an all-false [P_max] map
        on the buffered path, which reads none)."""
        v = v.to(self.device, torch.float32)
        if self.spec.update_path == "buffered":
            stats, st = self._append_buffer(state, v[None], [True])
            return (OpStats(*[f[0] for f in stats]), st,
                    torch.zeros((state.store.p_max,), dtype=torch.bool,
                                device=self.device))
        cache = cache_mod.open(state.cache)
        stats, st, seen = self._insert_one(_owned(state), v, cache)
        return stats, dataclasses.replace(st, cache=cache.state()), seen

    def insert_batch(self, state: EngineState, vectors: torch.Tensor):
        """Insertions one after another (the reference's scan).  Returns
        (per-insert OpStats [B], new state)."""
        vs = vectors.to(self.device, torch.float32)
        if self.spec.update_path == "buffered":
            return self._append_buffer(state, vs, [True] * vs.shape[0])
        cache = cache_mod.open(state.cache)
        st, stats = _owned(state), []
        for i in range(vs.shape[0]):
            s_i, st, _ = self._insert_one(st, vs[i], cache)
            stats.append(s_i)
        return _stack_stats(stats), dataclasses.replace(st,
                                                        cache=cache.state())

    def insert_many(self, state: EngineState, vectors: torch.Tensor,
                    valid: torch.Tensor | None = None):
        """Batch-parallel insert fan-out: the wave position-seeks at once,
        only the structural commits run one after another.

        Phase ①: one batch-first :func:`insert.position_seek` over the
        frozen snapshot (one lane per insert, one ``casr_rerank`` launch
        on the card), each lane charging its own counters and recording
        its trace; the traces replay into the cache in wave order.

        Phase ②: the reference's commit scan, commit for commit: picks
        re-validated against the edgelists earlier commits changed, an
        RMW re-read charged for each neighbor page the wave dirtied,
        reclaimed slots before fresh ones, NAVIS-update and the
        entrance-aware admit; commits past capacity are dropped.  The
        state is read back on the host once before the commits (the free
        list, the live entrance members, the new slots' membership) and
        the commits' cache effects (eviction hints, then the admit, per
        commit) go to the cache after them as one stream, in commit order
        (no commit reads the cache), so the commits queue on the device
        without a sync.

        On the buffered path there is nothing to fan out: the kept
        vectors are appended to the buffer in order (no position seeking,
        no kernels).

        ``valid`` [B] masks padding lanes: they charge nothing, replay
        nothing and commit nothing.  Returns (per-insert OpStats [B], new
        state); ``last_wave_timing`` holds seek_s, replay_s and commit_s
        (append_s on the buffered path).
        """
        spec = self.spec
        dev = self.device
        vs = vectors.to(dev, torch.float32)
        b = vs.shape[0]
        ok = (torch.ones((b,), dtype=torch.bool, device=dev) if valid is None
              else valid.to(dev, torch.bool))
        keep = ok.tolist()
        if spec.update_path == "buffered":
            with spans.span("append") as append:
                out = self._append_buffer(state, vs, keep)
            self.last_wave_timing = {"append_s": append.seconds}
            return out

        # -- phase ①: concurrent position seek on the frozen snapshot -----
        with spans.span("seek") as seek_span:
            new_codes = pq_mod.encode(self.codec, vs)             # [B, M]
            entries, e_ent = self._entries(state, pq_mod.adc_lut(self.codec,
                                                                 vs))
            seek = insert_mod.position_seek(
                state.store, spec.lspec, self.codec, state.codes, state.cache,
                IOCounters.zeros((b,), dev), vs, entries, e_pos=spec.e_pos,
                k=spec.k, s=spec.s_pos, rerank=spec.rerank,
                beam_width=spec.beam_width, max_hops=spec.max_hops,
                tombstone=state.tombstone, visited=spec.visited_impl)
            ctrs = seek.counters
            if spec.rerank == "full":
                # the classifier reads the snapshot, as the reference's wave
                ctrs = self._reclassify(ctrs, vs, seek.pool_ids, state.store)
            # padding lanes charge nothing and replay nothing
            ctrs = ctrs.map(lambda x: torch.where(ok, x, 0))
            rounds = torch.where(ok, seek.hops + seek.rerank_rounds, 0)
            traces = torch.where(ok[:, None], seek.trace, -1)
            spans.sync(vs)
        with spans.span("replay") as replay_span:
            cache = cache_mod.open(state.cache)
            cache.replay(traces)
            spans.sync(vs)

        # -- phase ②: serial conflict-aware commits -----------------------
        with spans.span("commit") as commit_span:
            st = _owned(state)
            store, ent = st.store, st.ent
            free = st.free_list[:st.free_count].tolist()
            count, free_count = store.count, st.free_count
            plan = []                      # (lane, slot, reused) per commit
            for i in range(b):
                if keep[i] and (count < store.n_max or free_count > 0):
                    reuse = free_count > 0
                    slot = free[free_count - 1] if reuse else count
                    free_count -= reuse
                    count = max(count, slot + 1)
                    plan.append((i, slot, reuse))
            slots = [slot for _, slot, _ in plan]
            is_member = (ent.main_to_ent[torch.tensor(slots, device=dev)] >= 0
                         ).tolist() if slots else []
            n_members = int((ent.ids >= 0).sum())
            dirty = torch.zeros((store.p_max,), dtype=torch.bool, device=dev)
            zero_ctr = IOCounters.zeros((), dev)
            commit_ctr = [zero_ctr] * b
            hints, admits, rereads = [], [], []
            for (i, slot, reuse), member in zip(plan, is_member):
                code = new_codes[i]
                st.codes[slot] = code
                nbrs = insert_mod.revalidate_neighbors(
                    seek.nbrs[i], slot, code, st.codes, self._sym,
                    st.tombstone)
                ctr, n_reread = insert_mod.charge_rmw_rereads(
                    zero_ctr, spec.lspec, store, nbrs, dirty)
                rereads.append(n_reread)
                page = store.next_page       # the new vertex's fresh page
                sres = insert_mod.commit_insert(store, spec.lspec, None, ctr,
                                                vs[i], nbrs, st.codes,
                                                self._sym, slot)
                store = sres.store
                if sres.dead_pages is not None:      # decoupled layout only
                    hints.append(sres.dead_pages)
                insert_mod.mark_dirty_pages(dirty, store, slot, nbrs,
                                            sres.modified)
                promoted = False
                if spec.entrance == "dynamic":
                    count0 = ent.count
                    ent = ent_mod.navis_update(
                        ent, slot, code, seek.pool_ids[i], e_ent[i],
                        store.count, st.codes, self._sym,
                        r_ent_frac=spec.ent_frac, n_members=n_members,
                        is_member=member)
                    promoted = ent.count > count0
                    n_members += promoted
                admits.append(page if promoted and
                              spec.cache_policy == "navis" else -1)
                st.tombstone[slot] = False
                st.free_mask[slot] = False
                st.young_mask[slot] = True
                commit_ctr[i] = sres.counters
            # the commits' cache effects in commit order, one stream: each
            # commit's eviction hints, then its promoted member's admit
            if plan and cache.policy != cache_mod.POLICIES["none"]:
                admit = torch.tensor(admits, dtype=torch.int32, device=dev)
                dead = (torch.stack(hints).to(torch.int32) if hints else
                        admit.new_empty((len(admits), 0)))
                kinds = torch.cat([
                    torch.full(dead.shape, cache_mod.INVALIDATE,
                               dtype=torch.int8, device=dev),
                    torch.full((len(admits), 1), cache_mod.PRIORITY_ADMIT,
                               dtype=torch.int8, device=dev)], 1)
                cache.apply(torch.cat([dead, admit[:, None]], 1).reshape(-1),
                            kinds.reshape(-1))
            n_reused = sum(reuse for _, _, reuse in plan)
            dropped = torch.tensor(keep, device=dev)
            dropped[[i for i, _, _ in plan]] = False
            per = merge_counters(ctrs, _join_counters(commit_ctr, torch.stack))
            stats = _delta_stats(IOCounters.zeros((b,), dev), per, rounds,
                                 dropped)
            st = dataclasses.replace(
                st, store=store, ent=ent, cache=cache.state(),
                n_deleted=st.n_deleted - n_reused,
                free_count=st.free_count - n_reused,
                ctr_insert=merge_counters(st.ctr_insert, sum_counters(per)))
            spans.sync(vs)
        self.last_wave_timing = {"seek_s": seek_span.seconds,
                                 "replay_s": replay_span.seconds,
                                 "commit_s": commit_span.seconds}
        self.last_wave_counts = {
            "rmw_rereads": int(torch.stack(rereads).sum()) if rereads
            else 0,
            "promotions": ent.count - state.ent.count,
            "priority_admits": sum(p >= 0 for p in admits)}
        return stats, st

    # -- FreshDiskANN's merge ------------------------------------------------

    def needs_merge(self, state: EngineState) -> bool:
        """The buffer holds at least ``buffer_frac`` of the index (float32
        arithmetic, as the reference), or is full, and is not empty."""
        frac = np.float32(self.spec.buffer_frac) * np.float32(
            state.store.count)
        thresh = max(int(frac), 1)
        return (state.buf_count >= min(thresh, self.spec.buffer_max) and
                state.buf_count > 0)

    def merge(self, state: EngineState):
        """FreshDiskANN StreamingMerge: insert every buffered vector in
        place, one after another through the threaded cache, their
        traversals sharing one dense page buffer (a page one of them read
        is free for the rest: the batched reads of a merge), then charge
        the stream rewrite of the whole index (every page read once and
        written once) and empty the buffer.  Returns (merge OpStats, new
        state)."""
        spec = self.spec
        cache = cache_mod.open(state.cache)
        st = _owned(state)
        page_seen = torch.zeros((st.store.p_max,), dtype=torch.bool,
                                device=self.device)
        for i in range(state.buf_count):
            _, st, seen = self._insert_one(st, state.buf_vecs[i], cache,
                                           page_seen=page_seen)
            page_seen = page_seen | seen
        n_pages = -(-st.store.count // spec.lspec.per_page)
        ctr = st.ctr_insert
        ctr = dataclasses.replace(
            ctr, read_requests=ctr.read_requests + n_pages,
            write_requests=ctr.write_requests + n_pages,
            pad_bytes_read=ctr.pad_bytes_read + n_pages * PAGE_BYTES,
            pad_bytes_written=ctr.pad_bytes_written + n_pages * PAGE_BYTES)
        stats = _delta_stats(state.ctr_insert, ctr, torch.zeros(
            (), dtype=torch.int32, device=self.device))
        return stats, dataclasses.replace(st, cache=cache.state(),
                                          ctr_insert=ctr, buf_count=0)

    # -- calibration (paper §5.2 warm-up) ----------------------------------

    def calibrate(self, state: EngineState, queries: torch.Tensor
                  ) -> EngineSpec:
        """Set ``s_search`` / ``s_pos`` from the 25th percentile of the
        vectors-to-converge distribution over warm-up queries (~100), for
        pools of ``e_search`` and ``e_pos``.  Pools do not depend on the
        cache, so one frozen wave per pool size gives the reference's
        (whose threaded cache it throws away).  Installs and returns the
        new spec."""
        spec = self.spec
        qs = queries.to(self.device, torch.float32)
        b = qs.shape[0]
        lut = pq_mod.adc_lut(self.codec, qs)
        entries, _ = self._entries(state, lut)
        s_vals = {}
        for name, pool_size in (("s_search", spec.e_search),
                                ("s_pos", spec.e_pos)):
            res = search_mod.disk_traverse(
                state.store, spec.lspec, lut, state.codes, state.cache,
                IOCounters.zeros((b,), self.device), entries,
                pool_size=pool_size, beam_width=spec.beam_width,
                max_hops=spec.max_hops, visited=spec.visited_impl)
            s_vals[name] = max(casr_mod.calibrate_group_size(
                state.store.vectors, res.pool_ids, qs, k=spec.k), 1)
        self.spec = spec.with_(**s_vals)
        return self.spec

    # -- delete (paper §11) ---------------------------------------------------

    def delete(self, state: EngineState, vid: int) -> EngineState:
        """Tombstone ``vid``: it leaves results and future wiring, and an
        entrance member is dropped with every reciprocal edge pointing at
        its slot (its own row stays, so traversals route through the
        hole).  Deleting a tombstoned id again changes nothing."""
        return self.delete_many(state, [int(vid)])

    def delete_many(self, state: EngineState, vids) -> EngineState:
        """:meth:`delete` for each id of ``vids`` in order (-1 skipped)."""
        vids = [int(v) for v in (vids.tolist() if isinstance(
            vids, torch.Tensor) else vids)]
        live = [v for v in vids if v >= 0]
        if not live:
            return state
        dev = state.tombstone.device
        idx = torch.tensor(live, device=dev)
        already = state.tombstone[idx].tolist()
        eslots = state.ent.main_to_ent[idx].tolist()
        tomb = state.tombstone.clone()
        ent = state.ent
        ent = dataclasses.replace(ent, ids=ent.ids.clone(),
                                  edges=ent.edges.clone(),
                                  main_to_ent=ent.main_to_ent.clone())
        done, n_deleted = set(), state.n_deleted
        for vid, was, eslot in zip(live, already, eslots):
            if was or vid in done:
                continue
            done.add(vid)
            if eslot >= 0:
                ent.ids[eslot] = -1
                ent.edges.masked_fill_(ent.edges == eslot, -1)
                ent.main_to_ent[vid] = -1
            n_deleted += 1
        tomb[idx] = True
        return dataclasses.replace(state, ent=ent, tombstone=tomb,
                                   n_deleted=n_deleted)

    # -- maintenance ----------------------------------------------------------

    def needs_consolidation(self, state: EngineState,
                            lookahead: int = 0) -> bool:
        """A pass is due when tombstones wait to be reclaimed and either
        their fraction of ``count`` reached ``consolidate_frac`` (float32,
        as the reference) or fewer than ``max(lookahead, 1)`` insertable
        slots remain (fresh headroom + free list); ``lookahead`` is the
        coming insert demand, e.g. the next wave's size."""
        pending = state.n_deleted - state.free_count
        count = max(state.store.count, 1)
        frac = np.float32(pending) / np.float32(count)
        headroom = state.store.n_max - state.store.count + state.free_count
        return pending > 0 and (
            bool(frac >= np.float32(self.spec.consolidate_frac)) or
            headroom < max(lookahead, 1))

    def _with_pages(self, state: EngineState, n_new: int) -> EngineState:
        """``state`` with room for ``n_new`` more fresh pages: the store's
        and the cache's page tables grow when the bump allocator would
        run past them (``layout.grow_pages``)."""
        need = state.store.next_page + n_new
        if need <= state.store.p_max:
            return state
        return dataclasses.replace(
            state, store=layout_mod.grow_pages(state.store, need),
            cache=cache_mod.grow(state.cache, need))

    def maintenance_step(self, state: EngineState):
        """One bounded increment of the consolidation cycle.

        While the repair cursor is inside ``[0, count)``, repairs the next
        ``maint_block`` rows (:func:`maintenance.repair_block`, no host
        sync) and advances.  Then finalizes the cycle: refines the live
        young vertices in blocks of 32 (``maint_refine``), reclaims every
        tombstoned slot into the free list, clears the reclaimed rows,
        defrags the edge pages (invalidating moved pages in the cache),
        refreshes the entrance and the default entries over the live set
        with the key ``fold_in(PRNGKey(1347), count * 131071 +
        n_deleted)`` (the data taken mod 2**32, where the reference's
        ``fold_in`` overflows past 32,768 vertices), priority-admits the
        members' pages, and resets the cursor.  All I/O lands in
        ``ctr_maint``.  Returns (new state, done: the cycle completed)."""
        spec = self.spec
        lspec = spec.lspec
        cur = state.maint_cursor
        if cur < state.store.count:
            if spec.layout == "decoupled":
                state = self._with_pages(
                    state, -(-spec.maint_block // lspec.per_page))
            st = _owned(state)
            store, cache, ctr, _ = maint_mod.repair_block(
                st.store, st.codes, self._sym, st.tombstone, st.cache,
                st.ctr_maint, cur, spec=lspec, block=spec.maint_block)
            return dataclasses.replace(
                st, store=store, cache=cache, ctr_maint=ctr,
                maint_cursor=cur + spec.maint_block), False

        spans.sync(state.tombstone)
        with spans.span("refine") as refine:
            yids = []
            if spec.maint_refine:
                # the live vertices inserted since the last pass, in id
                # order
                yids = torch.nonzero(state.young_mask & state.live_mask
                                     )[:, 0].tolist()
                if yids and spec.layout == "decoupled":
                    state = self._with_pages(
                        state, len(yids) * insert_mod.pages_per_insert(lspec))
            st = _owned(state)
            if yids:
                store, ctr = st.store, st.ctr_maint
                for s in range(0, len(yids), 32):
                    store, ctr = maint_mod.refine_block(
                        store, self.codec, st.codes, st.tombstone, st.cache,
                        ctr, yids[s:s + 32], st.default_entries, spec=lspec,
                        e_pos=spec.e_pos, beam_width=spec.beam_width,
                        max_hops=spec.max_hops, visited=spec.visited_impl)
                st.young_mask.zero_()
                st = dataclasses.replace(st, store=store, ctr_maint=ctr)
            spans.sync(st.tombstone)

        with spans.span("reclaim_defrag") as reclaim:
            store, free_count, cache, ctr = maint_mod.reclaim_and_defrag(
                st.store, st.tombstone, st.free_list, st.free_count,
                st.free_mask, st.cache, st.ctr_maint, spec=lspec)
            st = dataclasses.replace(st, store=store, free_count=free_count,
                                     cache=cache, ctr_maint=ctr,
                                     maint_cursor=0)
            spans.sync(st.tombstone)

        with spans.span("refresh") as refresh:
            live_ids = torch.nonzero(st.live_mask)[:, 0].to(torch.int32)
            key = jr.fold_in(jr.PRNGKey(1347),
                             store.count * 131071 + st.n_deleted)
            n_live = live_ids.shape[0]
            ent = st.ent
            if spec.entrance != "none" and n_live >= 2:
                # a dynamic entrance tops itself back up through Algorithm
                # 2 as inserts flow; a static one is refreshed only here
                ent = maint_mod.refresh_entrance(
                    key, st.codes, self._sym, st.ent, st.tombstone,
                    live_ids.cpu().numpy(), sample_frac=spec.ent_frac,
                    r_ent=spec.r_ent, n_max=store.n_max,
                    top_up=spec.entrance != "dynamic")
                cache = maint_mod.admit_entrance_pages(cache, store, ent)
            default_entries = st.default_entries
            if n_live > 0:
                default_entries = maint_mod.refresh_default_entries(
                    jr.fold_in(key, 1), store.vectors, live_ids,
                    spec.n_entry)
            spans.sync(st.tombstone)
        self.last_maint_timing = {
            "refine_s": refine.seconds, "refine_blocks": -(-len(yids) // 32),
            "reclaim_defrag_s": reclaim.seconds,
            "refresh_s": refresh.seconds}
        return dataclasses.replace(st, ent=ent, cache=cache,
                                   default_entries=default_entries), True

    def consolidate(self, state: EngineState):
        """One full pass: the repair sweep over ``[0, count)``, then the
        finalization.  Returns (OpStats of the pass from ``ctr_maint``,
        ``serial_rounds`` = steps taken, new state)."""
        ctr0 = state.ctr_maint
        state = dataclasses.replace(state, maint_cursor=0)
        steps = 0
        with spans.span("repair") as repair:
            while state.maint_cursor < state.store.count:       # the sweep
                state, _ = self.maintenance_step(state)
                steps += 1
            spans.sync(state.tombstone)
        state, _ = self.maintenance_step(state)             # finalization
        steps += 1
        self.last_maint_timing["repair_s"] = repair.seconds
        stats = _delta_stats(ctr0, state.ctr_maint, torch.tensor(
            steps, dtype=torch.int32, device=self.device))
        return stats, state
