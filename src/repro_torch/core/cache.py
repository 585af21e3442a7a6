"""Host-memory edgelist-page caches (NAVIS §7) + baseline policies (port
of ``repro/core/cache.py``).

NAVIS-cache: a mostly-frozen region (90% of capacity, randomized eviction
with up to 8 probes that skip recently-used entries) plus a tiny LRU
admission window (10%).  A page must be hit twice inside the window to be
promoted to the frozen region.  Baselines: LRU, CLOCK (FIFO + second
chance), LFU, and ``none``.

Reads and replay are split, as in the reference.  During a wave every
traversal probes one snapshot with :func:`lookup` (a gather of ``status``
on the device) and records the pages it charged.  :func:`apply_traces`
then replays the wave's traces in order, one :func:`access` per page —
a serial state machine with threefry draws on each promotion.  The port
runs that replay on the host, over Python lists, as the paper's cache
lives in host DRAM: the state is copied to the host once per wave and
back once, and the eviction draws run threefry on Python ints.
``chip_smoke.py`` times it as a phase of every wave; a device-side replay
is later work.

The sequential (threaded) paths, ``Engine.search`` / ``insert`` and their
batches, and an insert wave's commit phase keep one :class:`HostCache`
unpacked for the whole operation: each charged page goes through
:meth:`HostCache.access` in order, eviction hints through
:meth:`HostCache.invalidate` and entrance promotions through
:meth:`HostCache.priority_admit`, and the state is packed once at the end.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device

NOT_CACHED, IN_WINDOW, IN_FROZEN = 0, 1, 2
POLICIES = {"navis": 0, "lru": 1, "clock": 2, "lfu": 3, "none": 4}
_PROBES = 8          # randomized-eviction probe budget (paper default)
_INUSE_TICKS = 64    # "currently in use" guard for frozen eviction


@dataclasses.dataclass
class CacheState:
    policy: int                  # POLICIES value
    status: torch.Tensor         # [P_max] int8
    hits: torch.Tensor           # [P_max] int32 (window hits / LFU freq)
    slot_of: torch.Tensor        # [P_max] int32 slot within its region
    window_pages: torch.Tensor   # [W] int32, -1 empty
    window_last: torch.Tensor    # [W] int32 last-access tick
    frozen_pages: torch.Tensor   # [F] int32, -1 empty
    frozen_last: torch.Tensor    # [F] int32 last-access tick
    frozen_fill: int
    clock_hand: int
    clock: int
    key: torch.Tensor            # int64 [2]: threefry key for eviction


def init_cache(p_max: int, capacity_pages: int, policy: str,
               key: torch.Tensor, window_frac: float = 0.10,
               device=None) -> CacheState:
    device = resolve_device(device)
    if policy == "navis":
        w = max(int(capacity_pages * window_frac), 1)
        f = max(capacity_pages - w, 1)
    elif policy == "none":
        w, f = 1, 1
    else:
        w, f = capacity_pages, 1
    full = lambda n: torch.full((n,), -1, dtype=torch.int32, device=device)
    return CacheState(
        policy=POLICIES[policy],
        status=torch.zeros((p_max,), dtype=torch.int8, device=device),
        hits=torch.zeros((p_max,), dtype=torch.int32, device=device),
        slot_of=full(p_max), window_pages=full(w), window_last=full(w),
        frozen_pages=full(f), frozen_last=full(f),
        frozen_fill=0, clock_hand=0, clock=0, key=key.to(device))


def lookup(st: CacheState, pages: torch.Tensor) -> torch.Tensor:
    """Pure hit test against a snapshot (any shape of page ids >= 0)."""
    if st.policy == POLICIES["none"]:
        return torch.zeros(pages.shape, dtype=torch.bool,
                           device=pages.device)
    return st.status[pages.long()] != NOT_CACHED


class HostCache:
    """A :class:`CacheState` unpacked on the host for the serial replay:
    the page-indexed tables as numpy copies, the small region tables as
    lists; :meth:`state` packs it back onto ``device``."""

    _PAGES = ("status", "hits", "slot_of")
    _REGIONS = ("window_pages", "window_last", "frozen_pages", "frozen_last")

    def __init__(self, st: CacheState):
        self.device = st.status.device
        for name in self._PAGES:
            setattr(self, name, np.array(getattr(st, name).cpu().numpy()))
        for name in self._REGIONS:
            setattr(self, name, getattr(st, name).cpu().tolist())
        self.policy = st.policy
        self.frozen_fill = st.frozen_fill
        self.clock_hand = st.clock_hand
        self.clock = st.clock
        self.key = tuple(int(k) for k in st.key.cpu())

    def state(self) -> CacheState:
        arrays = {n: torch.from_numpy(getattr(self, n)).to(self.device)
                  for n in self._PAGES}
        arrays.update({n: torch.tensor(getattr(self, n), dtype=torch.int32,
                                       device=self.device)
                       for n in self._REGIONS})
        return CacheState(policy=self.policy, frozen_fill=self.frozen_fill,
                          clock_hand=self.clock_hand, clock=self.clock,
                          key=torch.tensor(self.key, dtype=torch.int64,
                                           device=self.device), **arrays)

    # -- NAVIS policy ------------------------------------------------------

    def _install_frozen(self, page: int) -> None:
        key, sub = jr.split_ints(self.key)
        f = len(self.frozen_pages)
        probes = jr.randint_ints(sub, _PROBES, 0, f)
        # prefer an empty probe, else the first not-recently-used, else 0
        scores = []
        for p in probes:
            if self.frozen_pages[p] < 0:
                scores.append(0)
            elif self.clock - self.frozen_last[p] >= _INUSE_TICKS:
                scores.append(1)
            else:
                scores.append(2)
        victim = probes[scores.index(min(scores))]
        old = self.frozen_pages[victim]
        if old >= 0:
            self.status[old] = NOT_CACHED
            self.slot_of[old] = -1
        if self.status[page] == IN_WINDOW:
            wslot = self.slot_of[page]
            self.window_pages[wslot] = -1
            self.window_last[wslot] = -1
        self.status[page] = IN_FROZEN
        self.slot_of[page] = victim
        self.frozen_pages[victim] = page
        self.frozen_last[victim] = self.clock
        self.frozen_fill += 0 if old >= 0 else 1
        self.key = key

    def _navis_hit_window(self, page: int) -> None:
        self.hits[page] += 1
        self.window_last[self.slot_of[page]] = self.clock
        if self.hits[page] >= 2:
            self._install_frozen(page)

    def _admit_window(self, page: int, victim: int) -> None:
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

    # -- single-region baselines ---------------------------------------------

    def _single_region_victim(self) -> int:
        w = len(self.window_pages)
        if self.policy == POLICIES["clock"]:
            for i in range(w):
                idx = (self.clock_hand + i) % w
                if self.clock - self.window_last[idx] >= _INUSE_TICKS:
                    return idx
            return self.clock_hand % w
        if self.policy == POLICIES["lfu"]:
            freq = [self.hits[max(p, 0)] if p >= 0 else -1
                    for p in self.window_pages]
            return freq.index(min(freq))
        return self.window_last.index(min(self.window_last))

    # -- one access ------------------------------------------------------------

    def access(self, page: int) -> bool:
        """One page access; returns whether it hit."""
        self.clock += 1
        if self.policy == POLICIES["none"]:
            return False
        hit = self.status[page] != NOT_CACHED
        navis = self.policy == POLICIES["navis"]
        if hit and navis:
            if self.status[page] == IN_FROZEN:
                self.frozen_last[self.slot_of[page]] = self.clock
            else:
                self._navis_hit_window(page)
        elif hit:
            self.window_last[self.slot_of[page]] = self.clock
            self.hits[page] += 1
        elif navis:
            self._admit_window(
                page, self.window_last.index(min(self.window_last)))
        else:
            victim = self._single_region_victim()
            self._admit_window(page, victim)
            if self.policy == POLICIES["clock"]:
                self.clock_hand = (victim + 1) % len(self.window_pages)
        return hit

    def priority_admit(self, page: int) -> None:
        """Admit ``page`` straight into the frozen region, bypassing the
        two-hits-in-window filter (the entrance-aware hint, §7): a freshly
        promoted entrance member's edgelist page is about to seed every
        traversal.  NAVIS policy only; a page already frozen only gets its
        in-use stamp refreshed.  No clock tick, no I/O."""
        if self.policy != POLICIES["navis"] or page < 0:
            return
        if self.status[page] == IN_FROZEN:
            self.frozen_last[self.slot_of[page]] = self.clock
        else:
            self._install_frozen(page)

    def replay(self, traces: torch.Tensor) -> int:
        """Access every page of each trace row ``[Q, T]`` (-1 padded, valid
        entries a prefix) in wave order; returns the hit count."""
        hits = 0
        for row in traces.cpu().tolist():
            for page in row:
                if page < 0:
                    break
                hits += self.access(page)
        return hits

    def invalidate(self, page: int) -> None:
        """Eviction hint when an edge page dies (§8.2)."""
        if self.status[page] == NOT_CACHED:
            return
        slot = self.slot_of[page]
        if self.status[page] == IN_WINDOW:
            self.window_pages[slot] = -1
            self.window_last[slot] = -1
        else:
            self.frozen_pages[slot] = -1
        self.status[page] = NOT_CACHED
        self.slot_of[page] = -1
        self.hits[page] = 0


def apply_traces(st: CacheState, traces: torch.Tensor
                 ) -> tuple[int, CacheState]:
    """Replay traces ``[Q, T]`` (int, -1-padded, valid entries a prefix of
    each row) in wave order; returns (replay hit count, new state).  The
    merged state evolves exactly as if the accesses had been issued one
    after another."""
    host = HostCache(st)
    hits = host.replay(traces)
    return hits, host.state()


def apply_trace(st: CacheState, trace: torch.Tensor
                ) -> tuple[int, CacheState]:
    """Replay one trace ``[T]``."""
    return apply_traces(st, trace[None])


def priority_admit(st: CacheState, page: int) -> CacheState:
    """:meth:`HostCache.priority_admit` on a packed state."""
    if st.policy != POLICIES["navis"] or page < 0:
        return st
    host = HostCache(st)
    host.priority_admit(page)
    return host.state()


def invalidate_pages(st: CacheState, pages: list[int]) -> CacheState:
    """Apply the eviction hint to each page id in ``pages``, in order."""
    if st.policy == POLICIES["none"] or not pages:
        return st
    host = HostCache(st)
    for p in pages:
        host.invalidate(p)
    return host.state()


def invalidate_where(st: CacheState, drop: torch.Tensor) -> CacheState:
    """The eviction hint applied to every page where ``drop`` [P_max] is
    True, at once on the state's device (no host sync): a page's hint
    touches only its own entries and its own region slot, so the order of
    the pages does not matter.  Returns a new state."""
    if st.policy == POLICIES["none"]:
        return st
    drop = drop & (st.status != NOT_CACHED)
    in_window = drop & (st.status == IN_WINDOW)
    in_frozen = drop & ~in_window
    slot = st.slot_of.long()

    def clear(region: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
        # pages not dropped write into a spare last entry
        n = region.shape[0]
        out = torch.cat([region, region[:1]])
        out[torch.where(which, slot, n)] = -1
        return out[:n]

    return dataclasses.replace(
        st, status=torch.where(drop, NOT_CACHED, st.status),
        slot_of=torch.where(drop, -1, st.slot_of),
        hits=torch.where(drop, 0, st.hits),
        window_pages=clear(st.window_pages, in_window),
        window_last=clear(st.window_last, in_window),
        frozen_pages=clear(st.frozen_pages, in_frozen))


def grow(st: CacheState, p_max: int) -> CacheState:
    """The state with its page tables grown to ``p_max`` pages (new pages
    not cached), beside ``layout.grow_pages``."""
    n = st.status.shape[0]
    if p_max <= n:
        return st

    def pad(t: torch.Tensor, fill: int) -> torch.Tensor:
        return torch.cat([t, t.new_full((p_max - n,), fill)])

    return dataclasses.replace(st, status=pad(st.status, NOT_CACHED),
                               hits=pad(st.hits, 0),
                               slot_of=pad(st.slot_of, -1))
