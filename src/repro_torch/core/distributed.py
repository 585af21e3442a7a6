"""The engine range-sharded over many shards (port of
``repro/core/distributed.py``).

Shard ``s`` of ``S`` owns the global ids ``[s * n_per, (s + 1) * n_per)``:
a private proximity graph, entrance graph, cache and PQ codes, under one
PQ codec trained on the global corpus.  Queries fan out to every shard and
the shards' top-k pools merge into the global top-k; inserts go to their
owner shard by id (``id % S``).  The shards are independent graphs, with
no edge between them.

The reference spreads the shards over a device mesh with ``shard_map``.
Here a shard count and an optional ``torch.distributed`` process group
take the mesh's place: ``S = world_size * shards_per_rank``
(:func:`n_shards`), and rank ``r`` owns the contiguous run of shards
:func:`owned_shards` gives.  A rank holds its shards as a list of
:class:`~repro_torch.core.engine.EngineState` in global shard order and
runs the engine's entry points on one state at a time.  ``group=None``
means one process owns every shard (all of them on one card).

- :func:`build_sharded_state` trains the global codec, then builds each
  owned shard from its id range.
- :func:`route_inserts` buckets new vectors by owner shard.
- :func:`make_sharded_search`: every shard searches the whole query wave
  (``search_many``), the pools are gathered across ranks
  (``all_gather_into_tensor``) and merged exactly as the reference's
  ``lax.top_k`` merges them.
- :func:`make_sharded_insert`: every shard inserts its own bucket
  (``insert_many``, or one insertion after another).
- :func:`state_shapes`: one shard's state on the meta device.
- :func:`dryrun`: both operations on a production mesh (one shard a
  device), counted per device on meta tensors through a
  :class:`CountingGroup`: the counterpart of the reference's ``dryrun``,
  which lowers and compiles them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as jr
from repro_torch.core import cache as cache_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import entrance as ent_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core.iomodel import IOCounters
from repro_torch.core.layout import empty_store
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import kind_record, new_kinds

INF = engine_mod.INF


class CountingGroup:
    """A stand-in for a process group of ``size`` ranks in a dry run: this
    process is rank 0, and every collective (the search's pool gathers)
    is counted in ``kinds`` (by ``launch.mesh.KINDS``: calls and result
    bytes) and returns an empty tensor of the shape the real one gives."""

    def __init__(self, size: int):
        self.size = size
        self.kinds = new_kinds()


def world(group=None) -> tuple[int, int]:
    """(number of ranks, this rank) of ``group``; (1, 0) without one."""
    if group is None:
        return 1, 0
    if isinstance(group, CountingGroup):
        return group.size, 0
    return dist.get_world_size(group), dist.get_rank(group)


def n_shards(group=None, shards_per_rank: int = 1) -> int:
    """The global shard count: ``shards_per_rank`` on every rank."""
    return world(group)[0] * shards_per_rank


def owned_shards(n_shards_: int, group=None) -> range:
    """The shards this rank owns: an equal, contiguous run of the
    ``n_shards_`` in rank order."""
    size, rank = world(group)
    if n_shards_ % size:
        raise ValueError(f"{n_shards_} shards do not split over {size} "
                         f"ranks")
    per = n_shards_ // size
    return range(rank * per, (rank + 1) * per)


# ---------------------------------------------------------------------------
# Host-side build and routing
# ---------------------------------------------------------------------------

def build_sharded_state(engine: engine_mod.Engine, key: torch.Tensor,
                        vectors: torch.Tensor, n_shards_: int, *,
                        group=None, build_block: int = 64,
                        build_e_pos: int = 64
                        ) -> list[engine_mod.EngineState]:
    """Range-shard ``vectors`` [N, D] and build this rank's shards.

    One codec is trained on a sample of ``min(N, 4096)`` rows of the
    global corpus (``choice(key, N, ..., replace=False)``) and installed
    before the builds, which keep it: per-shard codecs would make PQ
    distances, and the global merge, incomparable across shards.  Shard
    ``s`` is built from rows ``[s * per, (s + 1) * per)``, ``per = N //
    n_shards_``, with the key ``fold_in(key, s)``.  Returns the owned
    shards' states in global shard order."""
    key = key.cpu()
    vectors = vectors.to(engine.device, torch.float32)
    n = vectors.shape[0]
    per = n // n_shards_
    pick = jr.choice(key, n, (min(n, 4096),), replace=False)
    engine.set_codec(pq_mod.train_pq(key, vectors[pick.to(engine.device)],
                                     engine.spec.pq_m))
    return [engine.build(jr.fold_in(key, s), vectors[s * per:(s + 1) * per],
                         build_block=build_block, build_e_pos=build_e_pos)
            for s in owned_shards(n_shards_, group)]


def route_inserts(vectors, ids, n_shards_: int, bucket: int, device=None):
    """Bucket ``vectors`` [B, D] by owner shard, ``id % n_shards_``, in
    input order, padding every bucket to ``bucket`` entries.  A shard's
    entries past ``bucket`` are dropped without notice, as in the
    reference: size ``bucket`` for the largest share.  Returns (routed
    [S, bucket, D] float32, valid [S, bucket] bool) on ``device``."""
    v = torch.as_tensor(vectors).detach().cpu().to(torch.float32).numpy()
    out = np.zeros((n_shards_, bucket, v.shape[1]), np.float32)
    valid = np.zeros((n_shards_, bucket), bool)
    fill = [0] * n_shards_
    for vec, i in zip(v, torch.as_tensor(ids).cpu().tolist()):
        s = int(i) % n_shards_
        if fill[s] < bucket:
            out[s, fill[s]] = vec
            valid[s, fill[s]] = True
            fill[s] += 1
    dev = resolve_device(device)
    return torch.from_numpy(out).to(dev), torch.from_numpy(valid).to(dev)


# ---------------------------------------------------------------------------
# Sharded operations
# ---------------------------------------------------------------------------

def _gather(local: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``local`` [S_loc, ...] concatenated in rank order, which
    is global shard order."""
    if group is None:
        return local
    size = world(group)[0]
    out = local.new_empty((size * local.shape[0],) + tuple(local.shape[1:]))
    if isinstance(group, CountingGroup):
        group.kinds["all-gather"]["calls"] += 1
        group.kinds["all-gather"]["bytes"] += out.numel() * out.element_size()
        return out
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return out


def merge_topk(all_ids: torch.Tensor, all_d: torch.Tensor, k: int):
    """The global top-k of every shard's pool: ids and dists [S, Q, k] ->
    (ids [Q, k], dists [Q, k]).  Among equal distances the lower flat
    index ``shard * k + slot`` wins, as ``lax.top_k`` orders them, so a
    stable sort (``torch.topk``'s tie order is unspecified on CUDA, and
    the INF padding ties on every query with fewer than k hits).  Ids are
    -1 where the distance is still INF."""
    s, q, kk = all_d.shape
    d = all_d.permute(1, 0, 2).reshape(q, s * kk)
    ids = all_ids.permute(1, 0, 2).reshape(q, s * kk)
    d, order = torch.sort(d, dim=1, stable=True)
    d = d[:, :k]
    ids = torch.gather(ids, 1, order[:, :k])
    return torch.where(d < INF, ids, -1), d


class ShardedSearch:
    """``(states, queries [Q, D]) -> (ids [Q, k], dists [Q, k], states)``:
    every owned shard searches the whole wave, the pools are gathered
    across the group and merged (:func:`merge_topk`).  Global ids are
    ``shard * n_per + local id``; a shard holding more than ``n_per``
    vertices raises ``ValueError``, since its ids past ``n_per`` would
    collide with the next shard's.  Each shard's updated state (its cache
    replay and search counters) comes back, in the order given.
    ``last_timing`` holds the host-clock seconds of the last call: the
    shard searches, the gather and the merge."""

    def __init__(self, engine: engine_mod.Engine, n_per: int, group=None,
                 parallel: bool = True):
        self.engine, self.n_per, self.group = engine, n_per, group
        self.search = engine.search_many if parallel else engine.search_batch
        self.last_timing: dict = {}

    def __call__(self, states: list, queries: torch.Tensor):
        first = world(self.group)[1] * len(states)
        over = [first + j for j, st in enumerate(states)
                if st.store.count > self.n_per]
        if over:
            raise ValueError(
                f"shards {over} hold more than n_per = {self.n_per} "
                f"vertices: their global ids would collide with the next "
                f"shard's")
        qs = queries.to(self.engine.device, torch.float32)
        t0 = time.perf_counter()
        pools, out = [], []
        for st in states:
            ids, dists, _, st = self.search(st, qs)
            pools.append((ids, dists))
            out.append(st)
        engine_mod._sync(qs)
        self.last_timing = {"search_s": time.perf_counter() - t0}
        ids, dists = self.merge(pools, first)
        return ids, dists, out

    def merge(self, pools: list, first: int):
        """The owned shards' pools ``[(ids [Q, k], dists [Q, k])]``, the
        first being shard ``first``'s: ids made global, gathered across
        the group and merged (:func:`merge_topk`)."""
        ids_l, d_l = [], []
        for j, (ids, dists) in enumerate(pools):
            ids_l.append(torch.where(ids >= 0, ids + (first + j) * self.n_per,
                                     -1))
            d_l.append(torch.where(ids >= 0, dists, INF))
        local_i, local_d = torch.stack(ids_l), torch.stack(d_l)
        engine_mod._sync(local_d)
        t1 = time.perf_counter()
        all_i, all_d = _gather(local_i, self.group), _gather(local_d,
                                                             self.group)
        engine_mod._sync(local_d)
        t2 = time.perf_counter()
        ids, dists = merge_topk(all_i, all_d, self.engine.spec.k)
        engine_mod._sync(local_d)
        self.last_timing.update(gather_s=t2 - t1,
                                merge_s=time.perf_counter() - t2)
        return ids, dists


def make_sharded_search(engine: engine_mod.Engine, n_per: int, group=None,
                        parallel: bool = True) -> ShardedSearch:
    """The sharded search (:class:`ShardedSearch`).  ``parallel=True``
    runs each shard's wave through ``search_many`` (one snapshot, traces
    replayed in query order), ``False`` through ``search_batch`` (one
    query after another); the ids and distances are the same."""
    return ShardedSearch(engine, n_per, group, parallel)


class ShardedInsert:
    """``(states, routed [S, bucket, D], valid [S, bucket]) -> states``, as
    :func:`route_inserts` gives them for all ``S`` shards: every owned
    shard inserts its own bucket's valid lanes.  ``last_stats`` holds each
    owned shard's per-lane OpStats [bucket] of the last call (padding
    lanes all zero and not dropped)."""

    def __init__(self, engine: engine_mod.Engine, bucket: int, group=None,
                 parallel: bool = True):
        self.engine, self.bucket, self.group = engine, bucket, group
        self.fan_out = parallel and engine.spec.update_path != "buffered"
        self.last_stats: list = []

    def _one_by_one(self, state, vecs, ok):
        """The kept lanes inserted one after another, in lane order (the
        reference's scan under the mask)."""
        lanes = torch.nonzero(ok)[:, 0]
        zero = engine_mod._zero_stats(torch.zeros_like(ok))
        stats = engine_mod.OpStats(*[f.clone() for f in zero])
        if lanes.numel():
            got, state = self.engine.insert_batch(state, vecs[lanes])
            for f, g in zip(stats, got):
                f[lanes] = g.to(f.dtype)
        return stats, state

    def __call__(self, states: list, routed: torch.Tensor,
                 valid: torch.Tensor) -> list:
        size, rank = world(self.group)
        s_all = size * len(states)
        if tuple(routed.shape[:2]) != (s_all, self.bucket) or \
                tuple(valid.shape) != (s_all, self.bucket):
            raise ValueError(
                f"want routed [{s_all}, {self.bucket}, D] and valid "
                f"[{s_all}, {self.bucket}], got {tuple(routed.shape)} and "
                f"{tuple(valid.shape)}")
        dev = self.engine.device
        first = rank * len(states)
        out, self.last_stats = [], []
        for j, st in enumerate(states):
            vecs = routed[first + j].to(dev, torch.float32)
            ok = valid[first + j].to(dev, torch.bool)
            if self.fan_out:
                stats, st = self.engine.insert_many(st, vecs, valid=ok)
            else:
                stats, st = self._one_by_one(st, vecs, ok)
            self.last_stats.append(stats)
            out.append(st)
        return out


def make_sharded_insert(engine: engine_mod.Engine, bucket: int, group=None,
                        parallel: bool = True) -> ShardedInsert:
    """The sharded insert (:class:`ShardedInsert`).  ``parallel=True``
    runs each bucket through ``insert_many(valid=)`` (the bucket
    position-seeks at once against the shard's snapshot, the commits run
    one after another); a buffered engine, or ``parallel=False``, inserts
    the kept lanes one after another instead."""
    return ShardedInsert(engine, bucket, group, parallel)


# ---------------------------------------------------------------------------
# Shapes without data
# ---------------------------------------------------------------------------

def state_shapes(engine: engine_mod.Engine, n_shards_: int, n_per: int
                 ) -> list[engine_mod.EngineState]:
    """The state of ``n_shards_`` shards of ``n_per`` vertices on the meta
    device: every tensor's shape and dtype, nothing allocated.  One entry
    per shard (the same object: a meta state holds no data).  The edge
    page space is ``layout.page_budget(n_per, r)``, where the reference
    sizes it ``2 * n_per``."""
    spec = engine.spec.with_(n_max=n_per)
    meta = torch.device("meta")
    store = empty_store(n_per, spec.dim, spec.r, device=meta)
    c_max = max(int(spec.ent_frac * n_per * 2), 64)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=meta)
    state = engine_mod.EngineState(
        store=store,
        codes=zeros((n_per, spec.pq_m), torch.uint8),
        ent=ent_mod.empty_entrance(c_max, spec.r_ent, n_per, meta),
        cache=cache_mod.init_cache(store.p_max, spec.cache_capacity_pages,
                                   spec.cache_policy, jr.PRNGKey(0),
                                   device=meta),
        tombstone=zeros((n_per,), torch.bool),
        default_entries=zeros((spec.n_entry,), torch.int32),
        ctr_search=IOCounters.zeros((), meta),
        ctr_insert=IOCounters.zeros((), meta),
        buf_vecs=zeros((spec.buffer_max, spec.dim), torch.float32),
        buf_count=0, n_deleted=0,
        free_list=torch.full((n_per,), -1, dtype=torch.int32, device=meta),
        free_count=0,
        free_mask=zeros((n_per,), torch.bool),
        maint_cursor=0,
        young_mask=zeros((n_per,), torch.bool),
        ctr_maint=IOCounters.zeros((), meta))
    return [state] * n_shards_


def _tree_bytes(obj) -> int:
    """The bytes of every tensor of a state (dataclasses of tensors and
    host ints)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_tree_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def dryrun(engine: engine_mod.Engine, mesh, *, n_per: int = 65_536,
           n_queries: int = 64, bucket: int = 8) -> dict:
    """The sharded search and insert on ``mesh`` (a ``launch.mesh.Mesh``,
    the virtual production mesh among them: one shard a device), per
    device, on meta tensors: the counterpart of the reference's
    ``dryrun``, which lowers and compiles both on the mesh.

    For each op (``"search"``, ``"insert"``): ``devices``; ``state_bytes``,
    a shard's state (:func:`state_shapes`); ``input_bytes``, what the op
    takes on a device (the query wave; the routed bucket and its mask);
    and ``collectives`` (``{"bytes_by_kind", "op_counts"}`` by the
    reference's kinds) from a :class:`CountingGroup` of the mesh's size:
    the search gathers every shard's ``[Q, k]`` pools, ids and distances
    (:meth:`ShardedSearch.merge` on the pools' shapes), the insert none.
    ``left_out`` names what no meta run counts: a shard's own search or
    insert, whose traversal runs hop by hop while any lane is still
    active (``core/search.py``), so its FLOPs and bytes depend on the
    data and are not written."""
    S = mesh.size
    spec = engine.spec
    state_bytes = _tree_bytes(state_shapes(engine, 1, n_per)[0])
    meta = torch.device("meta")
    group = CountingGroup(S)
    search = ShardedSearch(engine, n_per, group)
    pool = (torch.empty((n_queries, spec.k), dtype=torch.int32, device=meta),
            torch.empty((n_queries, spec.k), dtype=torch.float32,
                        device=meta))
    search.merge([pool], 0)
    left_out = ("the shard's own traversal: its hops run while any lane "
                "is active (core/search.py), a loop on the data that no "
                "meta run counts, so its FLOPs and bytes are not written")
    f32 = torch.finfo(torch.float32).bits // 8

    def record(kinds, input_bytes):
        return {"devices": S, "state_bytes": state_bytes,
                "input_bytes": input_bytes,
                "collectives": kind_record(kinds), "left_out": left_out}
    return {"search": record(group.kinds, n_queries * spec.dim * f32),
            "insert": record(new_kinds(), bucket * spec.dim * f32 + bucket)}
