"""State interop with the reference package, through numpy.

Turns the reference's state objects (``EngineState``, ``GraphStore``,
``PQCodec``, ``EntranceGraph``, ``CacheState``, ``IOCounters`` and the
engine's spec and codec) into the port's, and any state object of either
package into nested dicts of numpy arrays keyed by the reference's field
names.  The LM substrate's trees (a parameter tree, a KV cache: nested
dicts and lists of arrays) go across leaf for leaf (``params_from``,
``kv_cache_from``; ``to_numpy`` turns either package's tree back).  It
reads the reference's objects only by field name through
``np.asarray(getattr(obj, name))``, so tests can hand JAX objects in
directly while this package imports no JAX.

The port's edge-page space is at least the reference's (see
``layout.page_budget``); page-indexed arrays are padded up to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import engine as engine_mod
from repro_torch.core import entrance as ent_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core.iomodel import IOCounters
from repro_torch.core.layout import GraphStore, page_budget
from repro_torch.device import resolve_device


def _a(obj, name: str) -> np.ndarray:
    return np.asarray(getattr(obj, name))


def _t(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """One array as a tensor.  A bfloat16 array (``ml_dtypes``, which
    ``torch.from_numpy`` rejects) goes across bit for bit as int16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def _pad(arr: np.ndarray, n: int, fill) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr
    return np.concatenate([arr, np.full((n - arr.shape[0],), fill,
                                        arr.dtype)])


def counters_from(ref, device=None) -> IOCounters:
    return IOCounters(*[_t(_a(ref, f.name), device, torch.int64)
                        for f in dataclasses.fields(IOCounters)])


def store_from(ref, device=None) -> GraphStore:
    edges = _a(ref, "edges")
    p_max = page_budget(edges.shape[0], edges.shape[1])
    return GraphStore(
        edges=_t(edges, device, torch.int32),
        degree=_t(_a(ref, "degree"), device, torch.int32),
        vectors=_t(_a(ref, "vectors"), device, torch.float32),
        count=int(_a(ref, "count")),
        edge_page=_t(_a(ref, "edge_page"), device, torch.int32),
        page_live=_t(_pad(_a(ref, "page_live"), p_max, 0), device,
                     torch.int32),
        next_page=int(_a(ref, "next_page")))


def codec_from(ref, device=None) -> pq_mod.PQCodec:
    return pq_mod.PQCodec(_t(_a(ref, "codebooks"), device, torch.float32))


def entrance_from(ref, device=None) -> ent_mod.EntranceGraph:
    return ent_mod.EntranceGraph(
        ids=_t(_a(ref, "ids"), device, torch.int32),
        edges=_t(_a(ref, "edges"), device, torch.int32),
        count=int(_a(ref, "count")),
        main_to_ent=_t(_a(ref, "main_to_ent"), device, torch.int32))


def cache_from(ref, p_max: int | None = None,
               device=None) -> cache_mod.CacheState:
    status = _a(ref, "status")
    p_max = p_max or status.shape[0]
    return cache_mod.CacheState(
        policy=int(_a(ref, "policy")),
        status=_t(_pad(status, p_max, 0), device, torch.int8),
        hits=_t(_pad(_a(ref, "hits"), p_max, 0), device, torch.int32),
        slot_of=_t(_pad(_a(ref, "slot_of"), p_max, -1), device,
                   torch.int32),
        window_pages=_t(_a(ref, "window_pages"), device, torch.int32),
        window_last=_t(_a(ref, "window_last"), device, torch.int32),
        frozen_pages=_t(_a(ref, "frozen_pages"), device, torch.int32),
        frozen_last=_t(_a(ref, "frozen_last"), device, torch.int32),
        frozen_fill=int(_a(ref, "frozen_fill")),
        clock_hand=int(_a(ref, "clock_hand")),
        clock=int(_a(ref, "clock")),
        key=_t(_a(ref, "key").astype(np.int64), device, torch.int64))


def engine_state_from(ref, device=None) -> engine_mod.EngineState:
    store = store_from(ref.store, device)
    return engine_mod.EngineState(
        store=store,
        codes=_t(_a(ref, "codes"), device, torch.uint8),
        ent=entrance_from(ref.ent, device),
        cache=cache_from(ref.cache, store.p_max, device),
        tombstone=_t(_a(ref, "tombstone"), device, torch.bool),
        default_entries=_t(_a(ref, "default_entries"), device, torch.int32),
        ctr_search=counters_from(ref.ctr_search, device),
        ctr_insert=counters_from(ref.ctr_insert, device),
        buf_vecs=_t(_a(ref, "buf_vecs"), device, torch.float32),
        buf_count=int(_a(ref, "buf_count")),
        n_deleted=int(_a(ref, "n_deleted")),
        free_list=_t(_a(ref, "free_list"), device, torch.int32),
        free_count=int(_a(ref, "free_count")),
        free_mask=_t(_a(ref, "free_mask"), device, torch.bool),
        maint_cursor=int(_a(ref, "maint_cursor")),
        young_mask=_t(_a(ref, "young_mask"), device, torch.bool),
        ctr_maint=counters_from(ref.ctr_maint, device))


class _ShardView:
    """Shard ``s`` of a stacked state object: array fields indexed at
    ``s`` on their leading axis, host values as they are, nested state
    objects viewed the same way."""

    def __init__(self, obj, s: int):
        self._obj, self._s = obj, s

    def __getattr__(self, name: str):
        v = getattr(self._obj, name)
        if hasattr(v, "shape"):
            return np.asarray(v)[self._s]
        if isinstance(v, (bool, int, float, str)):
            return v
        return _ShardView(v, self._s)


def sharded_state_from(ref_stacked, device=None
                       ) -> list[engine_mod.EngineState]:
    """The reference's stacked sharded state (a leading shard axis on
    every array, as its ``build_sharded_state`` returns it) as one port
    ``EngineState`` per shard, in shard order."""
    n = np.asarray(ref_stacked.store.count).shape[0]
    return [engine_state_from(_ShardView(ref_stacked, s), device)
            for s in range(n)]


def spec_from(ref) -> engine_mod.EngineSpec:
    return engine_mod.EngineSpec(**{
        f.name: getattr(ref, f.name)
        for f in dataclasses.fields(engine_mod.EngineSpec)})


def bundle_from(ref_bundle, device=None):
    """The reference's ``Engine.bundle`` ``(codec, codes, store)`` as the
    port's, for ``Engine.build(shared=...)``."""
    codec, codes, store = ref_bundle
    return (codec_from(codec, device),
            _t(np.asarray(codes), device, torch.uint8),
            store_from(store, device))


def engine_from(ref_engine, device=None) -> engine_mod.Engine:
    """A port engine with the reference engine's spec and codec."""
    eng = engine_mod.Engine(spec_from(ref_engine.spec), device=device)
    eng.set_codec(codec_from(ref_engine.codec, eng.device))
    return eng


def _tree_from(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_from(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from(v, device, dtype) for v in tree]
    return _t(tree, device, dtype)


def params_from(ref_params, device=None, dtype=None) -> dict:
    """The reference's LM parameter tree (``repro.models.transformer``
    ``init_params``: dicts, lists of patterns of stages, stacked
    ``[repeats, count, ...]`` leaves) as the port's, leaf for leaf, cast
    to ``dtype`` where given."""
    return _tree_from(ref_params, device, dtype)


def kv_cache_from(ref_cache, device=None) -> list:
    """The reference's KV cache (a list of patterns of stages of
    ``{"k", "v"}``, ``[repeats, count, B, slen, KV, hd]``) as the port's."""
    return _tree_from(ref_cache, device, None)


def to_numpy(obj):
    """Any state object of either package -> nested dicts of numpy arrays
    keyed by field name (NamedTuples by their fields); an LM tree's dicts
    and lists stay dicts and lists.  bfloat16 leaves come back as float32
    (exact)."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu()
        return (obj.float() if obj.dtype == torch.bfloat16 else obj).numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_numpy(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    arr = np.asarray(obj)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr
