"""The NAVIS engine (port of ``repro/core/engine.py``), ``navis`` preset.

``Engine(preset("navis", dim=768)).build(key, vectors)`` builds the index.
Then, as in the reference:

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

Every operation leaves its input state untouched and returns a new one:
it copies the tensors it mutates once per call, then writes them in
place.  The packed and full-rerank presets, the buffered path and
maintenance come in later slices and raise ``NotImplementedError``.
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
from repro_torch.core import insert as insert_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core import visited as visited_mod
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
        # host-clock seconds of the last wave.  search_many: traversal +
        # rerank on the device (until its traces reach the host; the CASR
        # stage alone, between two syncs, in casr_s), then the cache
        # replay.  insert_many: seek_s (phase ① until its traces reach the
        # host), replay_s, commit_s (phase ②, the cache packed)
        self.last_wave_timing: dict = {}
        # insert_many: RMW re-reads charged, entrance promotions and
        # priority admits of the last wave
        self.last_wave_counts: dict = {}
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

    def _search_core(self, state: EngineState, qs: torch.Tensor,
                     cache=None):
        """Traverse + CASR, one lane per query: a wave against the frozen
        snapshot ``state.cache``, or one query threaded through ``cache``
        (a :class:`cache.HostCache`).  Returns (ids, dists, stats,
        counters, traverse result)."""
        spec = self.spec
        b = qs.shape[0]
        ctr0 = IOCounters.zeros((b,), qs.device)
        lut = pq_mod.adc_lut(self.codec, qs)
        entries, _ = self._entries(state, lut)
        res = search_mod.disk_traverse(
            state.store, spec.lspec, lut, state.codes,
            state.cache if cache is None else cache, ctr0,
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

    def search(self, state: EngineState, q: torch.Tensor):
        """One sequential search, its traversal threaded through the cache
        page by page.  Returns (ids [k], dists [k], stats, new state)."""
        ids, dists, stats, state = self.search_batch(state, q[None])
        return ids[0], dists[0], OpStats(*[f[0] for f in stats]), state

    def search_batch(self, state: EngineState, queries: torch.Tensor):
        """Searches one after another, the cache and the search counters
        threaded through them.  Returns (ids [Q, k], dists [Q, k],
        per-query OpStats, new state)."""
        self._check_sliced()
        qs = queries.to(self.device, torch.float32)
        host = cache_mod.HostCache(state.cache)
        ids, dists, stats, ctrs = [], [], [], []
        for i in range(qs.shape[0]):
            out = self._search_core(state, qs[i:i + 1], host)
            for acc, x in zip((ids, dists, stats, ctrs), out):
                acc.append(x)
        state = dataclasses.replace(
            state, cache=host.state(),
            ctr_search=merge_counters(state.ctr_search, sum_counters(
                _join_counters(ctrs, torch.cat))))
        return (torch.cat(ids), torch.cat(dists),
                OpStats(*[torch.cat(f) for f in zip(*stats)]), state)

    # -- insert ---------------------------------------------------------------

    def _empty_page_seen(self) -> visited_mod.HashVisited:
        """What a skipped insert hands back for its traversal's pages."""
        spec = self.spec
        hv = visited_mod.make_hash(spec.max_hops * spec.beam_width, 1,
                                   self.device)
        return visited_mod.HashVisited(hv.keys[0], hv.count[0],
                                       hv.overflow[0])

    def _insert_one(self, st: EngineState, v: torch.Tensor,
                    host: cache_mod.HostCache):
        """One sequential insertion (the reference's ``_insert_inplace``)
        into ``st``, which the caller owns (written in place; the returned
        state shares its tensors), its cache unpacked in ``host``.
        Returns (stats, state, page_seen)."""
        spec = self.spec
        dev = self.device
        ctr0 = IOCounters.zeros((), dev)
        # capacity guard: with no free slot left past n_max the insertion
        # is skipped before it reserves a page, and flagged dropped
        if st.store.count >= st.store.n_max and st.free_count <= 0:
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            return (_delta_stats(ctr0, ctr0, zero, torch.ones(
                (), dtype=torch.bool, device=dev)), st,
                self._empty_page_seen())
        lut = pq_mod.adc_lut(self.codec, v[None])
        entries, e_ent = self._entries(st, lut)
        # reclaimed slots are reused before fresh ones
        reuse = st.free_count > 0
        slot = (int(st.free_list[st.free_count - 1]) if reuse
                else st.store.count)
        new_code = pq_mod.encode(self.codec, v[None])[0]
        st.codes[slot] = new_code
        ires = insert_mod.insert_vertex(
            st.store, spec.lspec, self.codec, st.codes, self._sym, host,
            ctr0, v, entries[0], e_pos=spec.e_pos, k=spec.k, s=spec.s_pos,
            beam_width=spec.beam_width, max_hops=spec.max_hops,
            tombstone=st.tombstone, new_id=slot)
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
                host.priority_admit(int(ires.store.edge_page[slot]))
        stats = _delta_stats(ctr0, ires.counters,
                             ires.hops + ires.rerank_rounds)
        st.tombstone[slot] = False
        st.free_mask[slot] = False
        st.young_mask[slot] = True
        st = dataclasses.replace(
            st, store=ires.store, ent=ent,
            n_deleted=st.n_deleted - reuse, free_count=st.free_count - reuse,
            ctr_insert=merge_counters(st.ctr_insert, ires.counters))
        return stats, st, ires.page_seen

    def insert(self, state: EngineState, v: torch.Tensor):
        """One sequential insertion.  Returns (stats, new state,
        page_seen: the pages its traversal read)."""
        self._check_sliced()
        host = cache_mod.HostCache(state.cache)
        stats, st, seen = self._insert_one(
            _owned(state), v.to(self.device, torch.float32), host)
        return stats, dataclasses.replace(st, cache=host.state()), seen

    def insert_batch(self, state: EngineState, vectors: torch.Tensor):
        """Insertions one after another (the reference's scan).  Returns
        (per-insert OpStats [B], new state)."""
        self._check_sliced()
        vs = vectors.to(self.device, torch.float32)
        host = cache_mod.HostCache(state.cache)
        st, stats = _owned(state), []
        for i in range(vs.shape[0]):
            s_i, st, _ = self._insert_one(st, vs[i], host)
            stats.append(s_i)
        return _stack_stats(stats), dataclasses.replace(st,
                                                        cache=host.state())

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
        the commits' cache effects are applied after them, in commit
        order (no commit reads the cache), so the commits queue on the
        device without a sync.

        ``valid`` [B] masks padding lanes: they charge nothing, replay
        nothing and commit nothing.  Returns (per-insert OpStats [B], new
        state); ``last_wave_timing`` holds seek_s, replay_s and commit_s.
        """
        self._check_sliced()
        spec = self.spec
        dev = self.device
        vs = vectors.to(dev, torch.float32)
        b = vs.shape[0]
        ok = (torch.ones((b,), dtype=torch.bool, device=dev) if valid is None
              else valid.to(dev, torch.bool))
        keep = ok.tolist()

        # -- phase ①: concurrent position seek on the frozen snapshot -----
        t0 = time.perf_counter()
        new_codes = pq_mod.encode(self.codec, vs)                 # [B, M]
        entries, e_ent = self._entries(state, pq_mod.adc_lut(self.codec,
                                                             vs))
        seek = insert_mod.position_seek(
            state.store, spec.lspec, self.codec, state.codes, state.cache,
            IOCounters.zeros((b,), dev), vs, entries, e_pos=spec.e_pos,
            k=spec.k, s=spec.s_pos, beam_width=spec.beam_width,
            max_hops=spec.max_hops, tombstone=state.tombstone)
        # padding lanes charge nothing and replay nothing
        ctrs = seek.counters.map(lambda x: torch.where(ok, x, 0))
        rounds = torch.where(ok, seek.hops + seek.rerank_rounds, 0)
        traces = torch.where(ok[:, None], seek.trace, -1).cpu()
        t1 = time.perf_counter()
        host = cache_mod.HostCache(state.cache)
        host.replay(traces)
        t2 = time.perf_counter()

        # -- phase ②: serial conflict-aware commits -----------------------
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
                seek.nbrs[i], slot, code, st.codes, self._sym, st.tombstone)
            ctr, n_reread = insert_mod.charge_rmw_rereads(
                zero_ctr, spec.lspec, store, nbrs, dirty)
            rereads.append(n_reread)
            page = store.next_page       # the new vertex's fresh page
            sres = insert_mod.commit_insert(store, spec.lspec, None, ctr,
                                            vs[i], nbrs, st.codes,
                                            self._sym, slot)
            store = sres.store
            hints.append(sres.dead_pages)
            insert_mod.mark_dirty_pages(dirty, store, slot, nbrs,
                                        sres.modified)
            promoted = False
            if spec.entrance == "dynamic":
                count0 = ent.count
                ent = ent_mod.navis_update(
                    ent, slot, code, seek.pool_ids[i], e_ent[i], store.count,
                    st.codes, self._sym, r_ent_frac=spec.ent_frac,
                    n_members=n_members, is_member=member)
                promoted = ent.count > count0
                n_members += promoted
            admits.append(page if promoted and
                          spec.cache_policy == "navis" else -1)
            st.tombstone[slot] = False
            st.free_mask[slot] = False
            st.young_mask[slot] = True
            commit_ctr[i] = sres.counters
        # the commits' cache effects in commit order: eviction hints, then
        # the promoted member's admit
        if plan and host.policy != cache_mod.POLICIES["none"]:
            for dead, page in zip(torch.stack(hints).tolist(), admits):
                for p in dead:
                    if p >= 0:
                        host.invalidate(p)
                host.priority_admit(page)
        n_reused = sum(reuse for _, _, reuse in plan)
        dropped = torch.tensor(keep, device=dev)
        dropped[[i for i, _, _ in plan]] = False
        per = merge_counters(ctrs, _join_counters(commit_ctr, torch.stack))
        stats = _delta_stats(IOCounters.zeros((b,), dev), per, rounds,
                             dropped)
        st = dataclasses.replace(
            st, store=store, ent=ent, cache=host.state(),
            n_deleted=st.n_deleted - n_reused,
            free_count=st.free_count - n_reused,
            ctr_insert=merge_counters(st.ctr_insert, sum_counters(per)))
        _sync(vs)
        self.last_wave_timing = {"seek_s": t1 - t0, "replay_s": t2 - t1,
                                 "commit_s": time.perf_counter() - t2}
        self.last_wave_counts = {
            "rmw_rereads": int(torch.stack(rereads).sum()) if rereads
            else 0,
            "promotions": ent.count - state.ent.count,
            "priority_admits": sum(p >= 0 for p in admits)}
        return stats, st

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
