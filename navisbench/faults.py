"""Faults planted in the timed path, underneath a run, to show that the
comparison that decides ``correct`` fails each (``control.py`` on the
card, the CPU tests at a tiny size).  The benchmark's own runs plant
none.

- ``half_searched``: half of a wave searched, the rest answered with the
  first lanes' answers;
- ``answer_altered``: one id of a wave's first answer altered;
- ``lanes_swapped``: each lane's candidates handed to the next lane's
  rerank, which then ranks the wrong lane's candidates exactly;
- ``one_hop``: the traversal stopped after one hop (``max_hops`` 1);
- ``replay_skipped``: the wave's page traces not replayed into the cache;
- ``state_unchanged``: ``search_many`` hands back the state it was given.
"""
from __future__ import annotations

import contextlib


def _half_searched(orig):
    def search_many(self, state, queries):
        import torch
        half = (queries.shape[0] + 1) // 2
        ids, d, stats, st = orig(self, state, queries[:half])
        rest = queries.shape[0] - half
        return (torch.cat([ids, ids[:rest]]), torch.cat([d, d[:rest]]),
                stats, st)
    return search_many


def _answer_altered(orig):
    def search_many(self, state, queries):
        ids, d, stats, st = orig(self, state, queries)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % state.store.count
        return ids, d, stats, st
    return search_many


def _one_hop(orig):
    def search_many(self, state, queries):
        spec = self.spec
        self.spec = spec.with_(max_hops=1)
        try:
            return orig(self, state, queries)
        finally:
            self.spec = spec
    return search_many


def _state_unchanged(orig):
    def search_many(self, state, queries):
        ids, d, stats, _ = orig(self, state, queries)
        return ids, d, stats, state
    return search_many


def _lanes_swapped(orig):
    def casr_rerank(store, lspec, qs, pool, *args, **kw):
        return orig(store, lspec, qs, pool.roll(1, 0).contiguous(), *args,
                    **kw)
    return casr_rerank


def _replay_skipped(orig):
    def apply_traces(st, traces):
        import torch
        return torch.zeros(1, dtype=torch.int32, device=traces.device), st
    return apply_traces


def _targets():
    from repro_torch.core import cache, casr, engine
    return {"half_searched": (engine.Engine, "search_many", _half_searched),
            "answer_altered": (engine.Engine, "search_many", _answer_altered),
            "one_hop": (engine.Engine, "search_many", _one_hop),
            "state_unchanged": (engine.Engine, "search_many",
                                _state_unchanged),
            "lanes_swapped": (casr, "casr_rerank", _lanes_swapped),
            "replay_skipped": (cache, "apply_traces", _replay_skipped)}


NAMES = ("half_searched", "answer_altered", "lanes_swapped", "one_hop",
         "replay_skipped", "state_unchanged")


@contextlib.contextmanager
def planted(*names: str):
    """Plant the faults ``names`` for the body of the ``with``."""
    targets = _targets()
    saved = []
    try:
        for name in names:
            owner, attr, make = targets[name]
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, make(orig))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)
