"""NAVIS core on PyTorch (port of ``repro/core``).

Public API:
    EngineSpec / Engine / EngineState / OpStats / preset / PRESETS
    GraphStore / LayoutSpec / empty_store / page_budget
    build_graph / brute_force_topk / recall_at_k / check_invariants /
        medoid / robust_prune
    IOCounters / SSDModel / merge_counters / sum_counters
    distributed: build_sharded_state / route_inserts / make_sharded_search /
        make_sharded_insert / state_shapes
"""
from repro_torch.core import distributed
from repro_torch.core.engine import (Engine, EngineSpec, EngineState, OpStats,
                                     PRESETS, preset)
from repro_torch.core.graph import (brute_force_topk, build_graph,
                                    check_invariants, medoid, recall_at_k,
                                    robust_prune)
from repro_torch.core.iomodel import (IOCounters, PAGE_BYTES, SSDModel,
                                      merge_counters, sum_counters)
from repro_torch.core.layout import (GraphStore, LayoutSpec, empty_store,
                                     page_budget)

__all__ = [
    "distributed", "Engine", "EngineSpec", "EngineState", "OpStats",
    "PRESETS", "preset",
    "brute_force_topk", "build_graph", "check_invariants", "medoid",
    "recall_at_k", "robust_prune", "IOCounters", "PAGE_BYTES", "SSDModel",
    "merge_counters", "sum_counters", "GraphStore", "LayoutSpec",
    "empty_store", "page_budget",
]
