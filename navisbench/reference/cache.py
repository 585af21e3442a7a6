"""The plain reference of the NAVIS page cache's replay (NAVIS §7), in
plain Python.

A wave's traversals read one snapshot of the cache; afterwards the pages
they charged replay into it in query order, one access per page.  The
policy: a frozen region (90% of the pages) whose victims are drawn by
randomized eviction (8 probes, an empty slot first, else the first slot
not used in the last 64 ticks, else the first probe), and an LRU
admission window (10%) from which a page hit twice is promoted.  The
probes are ``jax.random.randint`` draws under a Threefry-2x32 key that
each promotion splits, so a replay is exact.

It imports nothing of the port: a state is a dict of numpy arrays and
ints under the fields' names (``status``, ``hits``, ``slot_of``,
``window_pages``, ``window_last``, ``frozen_pages``, ``frozen_last``,
``frozen_fill``, ``clock``, ``key``).
"""
from __future__ import annotations

import numpy as np

NOT_CACHED, IN_WINDOW, IN_FROZEN = 0, 1, 2
PROBES = 8
IN_USE_TICKS = 64
MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
FIELDS = ("status", "hits", "slot_of", "window_pages", "window_last",
          "frozen_pages", "frozen_last", "frozen_fill", "clock", "key")


def threefry2x32(k1: int, k2: int, x1: int, x2: int) -> tuple[int, int]:
    """Threefry-2x32, 20 rounds, of the counter (x1, x2) under (k1, k2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1, x2 = (x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` (partitionable counters)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def randint(key: tuple[int, int], n: int, lo: int, hi: int) -> list[int]:
    """``jax.random.randint(key, (n,), lo, hi)`` for int32."""
    span = max(hi - lo, 1)
    k_hi, k_lo = split(key)
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    out = []
    for i in range(n):
        a, b = threefry2x32(k_hi[0], k_hi[1], 0, i)
        c, d = threefry2x32(k_lo[0], k_lo[1], 0, i)
        off = ((((a ^ b) % span) * mult & MASK) + (c ^ d) % span) & MASK
        out.append(off % span + lo)
    return out


class NavisCache:
    """One state of the cache, advanced access by access."""

    def __init__(self, state: dict):
        self.status = np.asarray(state["status"]).tolist()
        self.hits = np.asarray(state["hits"]).tolist()
        self.slot_of = np.asarray(state["slot_of"]).tolist()
        self.window_pages = np.asarray(state["window_pages"]).tolist()
        self.window_last = np.asarray(state["window_last"]).tolist()
        self.frozen_pages = np.asarray(state["frozen_pages"]).tolist()
        self.frozen_last = np.asarray(state["frozen_last"]).tolist()
        self.frozen_fill = int(state["frozen_fill"])
        self.clock = int(state["clock"])
        self.key = tuple(int(k) for k in np.asarray(state["key"]))

    def state(self) -> dict:
        out = {f: np.asarray(getattr(self, f)) for f in FIELDS}
        out["status"] = out["status"].astype(np.int8)
        return out

    def _promote(self, page: int) -> None:
        """Install ``page`` into the frozen region over a drawn victim."""
        self.key, sub = split(self.key)
        probes = randint(sub, PROBES, 0, len(self.frozen_pages))

        def score(p):
            if self.frozen_pages[p] < 0:
                return 0
            return 1 if self.clock - self.frozen_last[p] >= IN_USE_TICKS \
                else 2
        scores = [score(p) for p in probes]
        victim = probes[scores.index(min(scores))]
        old = self.frozen_pages[victim]
        if old >= 0:
            self.status[old] = NOT_CACHED
            self.slot_of[old] = -1
        else:
            self.frozen_fill += 1
        if self.status[page] == IN_WINDOW:
            w = self.slot_of[page]
            self.window_pages[w] = -1
            self.window_last[w] = -1
        self.status[page] = IN_FROZEN
        self.slot_of[page] = victim
        self.frozen_pages[victim] = page
        self.frozen_last[victim] = self.clock

    def access(self, page: int) -> bool:
        """One page access; whether it hit."""
        self.clock += 1
        s = self.status[page]
        if s == IN_FROZEN:
            self.frozen_last[self.slot_of[page]] = self.clock
        elif s == IN_WINDOW:
            self.hits[page] += 1
            self.window_last[self.slot_of[page]] = self.clock
            if self.hits[page] >= 2:
                self._promote(page)
        else:
            victim = self.window_last.index(min(self.window_last))
            old = self.window_pages[victim]
            if old >= 0:
                self.status[old] = NOT_CACHED
                self.slot_of[old] = -1
                self.hits[old] = 0
            self.status[page] = IN_WINDOW
            self.slot_of[page] = victim
            self.hits[page] = 1
            self.window_pages[victim] = page
            self.window_last[victim] = self.clock
        return s != NOT_CACHED


def snapshot_hits(state: dict, traces: np.ndarray) -> int:
    """Charged pages that the snapshot ``state`` holds: the hits a wave's
    traversals count (each row's pages up to its first -1)."""
    t = np.asarray(traces)
    charged = np.cumprod(t >= 0, axis=1).astype(bool)
    status = np.asarray(state["status"])
    return int((status[np.where(charged, t, 0)] != NOT_CACHED)[charged].sum())


def replay(state: dict, traces: np.ndarray) -> dict:
    """The state after the wave's traces [Q, T] replay into ``state``, row
    after row, each up to its first -1."""
    cache = NavisCache(state)
    for row in np.asarray(traces).tolist():
        for page in row:
            if page < 0:
                break
            cache.access(page)
    return cache.state()


def differences(got: dict, want: dict) -> int:
    """Entries in which two states differ, over every field (a field of
    another size differs in all its entries)."""
    n = 0
    for f in FIELDS:
        a = np.asarray(got[f]).reshape(-1)
        b = np.asarray(want[f]).reshape(-1)
        n += int(np.count_nonzero(a != b)) if a.shape == b.shape else \
            max(a.size, b.size)
    return n
