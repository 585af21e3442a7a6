"""What the window's searches did to the page cache, for the comparison
that decides ``correct``.

A search changes no state but the page cache: ``search_many`` replays the
wave's page traces into it through ``repro_torch.core.cache.apply_traces``
(its answers do not read the result, only the next wave's hit counts do).
While the window runs, the watch wraps that call and keeps:

- ``breaks``: waves whose cache is not the one the wave before left (the
  first wave: the cache the window began with; after the last: the cache
  the engine's state holds at the end): a replay whose result was
  dropped, or a state handed on unchanged;
- a sample of waves drawn from the seed (reservoir sampling, so it needs
  no wave count in advance): the cache before the wave, the wave's traces
  and the cache after it.  The reference replays the traces from the
  same cache before and must reach the same cache after.

It keeps references to the program's tensors, no copies, so the window
pays no more than a wrapper call a wave; the sampled waves go to the host
after the window has closed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _same(a, b) -> bool:
    if a is b:
        return True
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in ((getattr(a, f.name), getattr(b, f.name))
                            for f in dataclasses.fields(a)))


def on_host(st) -> dict:
    """A ``CacheState`` as the reference's dict of numpy arrays and ints."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
            out[f.name] = int(v) if v.ndim == 0 else v
        else:
            out[f.name] = v
    return out


class CacheWatch:
    """Wraps the cache's replay between :meth:`open` and :meth:`close`."""

    def __init__(self, start, seed: int, sample: int):
        self.last = start            # the cache the next wave must read
        self.breaks = 0
        self.waves = 0
        self.sample = sample
        self.kept: list = []         # (wave, before, traces, after)
        self._rng = np.random.default_rng(seed)
        self._saved = None

    def open(self) -> "CacheWatch":
        from repro_torch.core import cache as cache_mod
        self._saved = cache_mod.apply_traces

        def apply_traces(st, traces):
            hits, after = self._saved(st, traces)
            self._seen(st, traces, after)
            return hits, after

        cache_mod.apply_traces = apply_traces
        return self

    def _seen(self, before, traces, after) -> None:
        if not _same(before, self.last):
            self.breaks += 1
        wave, self.waves = self.waves, self.waves + 1
        item = (wave, before, traces, after)
        if len(self.kept) < self.sample:
            self.kept.append(item)
        else:
            j = int(self._rng.integers(0, wave + 1))
            if j < self.sample:
                self.kept[j] = item
        self.last = after

    def close(self, end, wave_hits: list) -> dict:
        """Unwrap; ``end``: the cache the engine's state holds now;
        ``wave_hits``: each wave's cache hits as the program counted them.
        Returns what the comparison reads, on the host."""
        from repro_torch.core import cache as cache_mod
        if self._saved is not None:
            cache_mod.apply_traces = self._saved
            self._saved = None
        if self.waves and not _same(end, self.last):
            self.breaks += 1
        kept = sorted(self.kept, key=lambda item: item[0])
        return {"breaks": self.breaks, "waves": self.waves,
                "sampled": [{"wave": w, "before": on_host(b),
                             "traces": t.cpu().numpy(), "after": on_host(a),
                             "hits": int(wave_hits[w])}
                            for w, b, t, a in kept]}
