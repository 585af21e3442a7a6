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
then replays the wave's traces in order, one access per page: a serial
state machine with threefry draws on each promotion.  The state lives on
its device, its scalars (``frozen_fill``, ``clock_hand``, ``clock``) as
0-d int32 tensors, so a wave needs no host sync for it.

:func:`open` gives a handle on a state: a :class:`DeviceCache` for a CUDA
state, which runs every call as one launch of the ``cache_replay`` /
``cache_ops`` kernel (``kernels/csrc/cache_replay.cu``) in place on its
own copy of the tables (made once; ``state()`` hands it over), and a
:class:`HostCache` for a CPU state, which runs the same state machine on
the host (the kernels' plain version, ``kernels.ref.cache_apply``).
Both take ``access`` (a threaded hop's charged pages), ``replay`` (a
wave's traces), ``invalidate`` (eviction hints), ``priority_admit``
(entrance promotions) and ``apply`` (a stream of the three), skip ``-1``
pages, and pack the state with ``state()``.
The sequential (threaded) paths, ``Engine.search`` / ``insert``, their
batches and FreshDiskANN's merge, keep one handle for the whole
operation; an insert wave's commits send their hints and admits as one
stream after the commits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

NOT_CACHED, IN_WINDOW, IN_FROZEN = 0, 1, 2
POLICIES = {"navis": 0, "lru": 1, "clock": 2, "lfu": 3, "none": 4}
_PROBES = 8          # randomized-eviction probe budget (paper default)
_INUSE_TICKS = 64    # "currently in use" guard for frozen eviction
ACCESS, INVALIDATE, PRIORITY_ADMIT = (kernel_ops.ACCESS, kernel_ops.INVALIDATE,
                                      kernel_ops.PRIORITY_ADMIT)
# the state's tensors, in the cache kernels' order (every field but policy)
TABLES = tuple(name for name, _, _ in kernel_ops.CACHE_TABLES)


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
    frozen_fill: torch.Tensor    # int32 0-d: installs into empty slots
    clock_hand: torch.Tensor     # int32 0-d (CLOCK policy)
    clock: torch.Tensor          # int32 0-d global tick
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
    zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return CacheState(
        policy=POLICIES[policy],
        status=torch.zeros((p_max,), dtype=torch.int8, device=device),
        hits=torch.zeros((p_max,), dtype=torch.int32, device=device),
        slot_of=full(p_max), window_pages=full(w), window_last=full(w),
        frozen_pages=full(f), frozen_last=full(f),
        frozen_fill=zero(), clock_hand=zero(), clock=zero(),
        key=key.to(device))


def lookup(st: CacheState, pages: torch.Tensor) -> torch.Tensor:
    """Pure hit test against a snapshot (any shape of page ids >= 0)."""
    if st.policy == POLICIES["none"]:
        return torch.zeros(pages.shape, dtype=torch.bool,
                           device=pages.device)
    return st.status[pages.long()] != NOT_CACHED


def _page_list(pages) -> list[int]:
    """Page ids as host ints (a tensor of any shape, a list or one int)."""
    if isinstance(pages, torch.Tensor):
        return pages.reshape(-1).tolist()
    return [int(pages)] if np.ndim(pages) == 0 else [int(p) for p in pages]


class HostCache:
    """A :class:`CacheState` unpacked on the host for the serial replay:
    the page-indexed tables as numpy copies, the small region tables as
    lists, the scalars and the key as ints; :meth:`state` packs it back
    onto ``device``.  The handle of a CPU state, and the cache kernels'
    plain version (``kernels.ref.cache_apply``)."""

    _PAGES = ("status", "hits", "slot_of")
    _REGIONS = ("window_pages", "window_last", "frozen_pages", "frozen_last")
    _SCALARS = ("frozen_fill", "clock_hand", "clock")

    def __init__(self, st: CacheState):
        self.device = st.status.device
        for name in self._PAGES:
            setattr(self, name, np.array(getattr(st, name).cpu().numpy()))
        for name in self._REGIONS:
            setattr(self, name, getattr(st, name).cpu().tolist())
        for name in self._SCALARS:
            setattr(self, name, int(getattr(st, name)))
        self.policy = st.policy
        self.key = tuple(int(k) for k in st.key.cpu())

    def state(self) -> CacheState:
        arrays = {n: torch.from_numpy(getattr(self, n).copy()).to(self.device)
                  for n in self._PAGES}
        arrays.update({n: torch.tensor(getattr(self, n), dtype=torch.int32,
                                       device=self.device)
                       for n in self._REGIONS + self._SCALARS})
        return CacheState(policy=self.policy,
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
        # counts installs into empty slots: invalidate never lowers it, so
        # a refilled slot counts twice (the reference's count)
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

    # -- one operation -------------------------------------------------------

    def _access(self, page: int) -> bool:
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
        return bool(hit)

    def _priority_admit(self, page: int) -> None:
        """Admit ``page`` straight into the frozen region, bypassing the
        two-hits-in-window filter (the entrance-aware hint, §7): a freshly
        promoted entrance member's edgelist page is about to seed every
        traversal.  NAVIS policy only; a page already frozen only gets its
        in-use stamp refreshed.  No clock tick, no I/O."""
        if self.policy != POLICIES["navis"]:
            return
        if self.status[page] == IN_FROZEN:
            self.frozen_last[self.slot_of[page]] = self.clock
        else:
            self._install_frozen(page)

    def _invalidate(self, page: int) -> None:
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

    def _check(self, page: int) -> None:
        if page >= len(self.status):
            raise IndexError(f"page {page} is past the cache's "
                             f"{len(self.status)} pages")

    def replay_rows(self, rows: list[list[int]]) -> int:
        """Access every page of each row, in order, up to the row's first
        -1; returns the hit count."""
        hits = 0
        for row in rows:
            for page in row:
                if page < 0:
                    break
                self._check(page)
                hits += self._access(page)
        return hits

    def run(self, pages: list[int], kinds: list[int]) -> int:
        """Run each (kind, page) in order, -1 pages skipped; returns the
        accesses' hit count."""
        hits = 0
        step = {INVALIDATE: self._invalidate,
                PRIORITY_ADMIT: self._priority_admit}
        for page, kind in zip(pages, kinds):
            if page < 0:
                continue
            self._check(page)
            if kind == ACCESS:
                hits += self._access(page)
            else:
                step[kind](page)
        return hits

    # -- the handle (as DeviceCache's) ---------------------------------------

    def _hits(self, n: int) -> torch.Tensor:
        return torch.tensor([n], dtype=torch.int32, device=self.device)

    def replay(self, traces: torch.Tensor) -> torch.Tensor:
        """Replay trace rows ``[Q, T]`` (-1 padded, valid entries a prefix)
        in wave order; returns the hit count, int32 [1]."""
        return self._hits(self.replay_rows(traces.tolist()))

    def access(self, pages) -> torch.Tensor:
        """Access ``pages`` in order (-1 skipped); returns the hits, int32
        [1]."""
        pages = _page_list(pages)
        return self._hits(self.run(pages, [ACCESS] * len(pages)))

    def invalidate(self, pages) -> None:
        pages = _page_list(pages)
        self.run(pages, [INVALIDATE] * len(pages))

    def priority_admit(self, pages) -> None:
        pages = _page_list(pages)
        self.run(pages, [PRIORITY_ADMIT] * len(pages))

    def apply(self, pages: torch.Tensor, kinds: torch.Tensor) -> torch.Tensor:
        """Run the stream ``pages`` [N] of ``kinds`` [N] in order."""
        return self._hits(self.run(pages.tolist(), kinds.tolist()))


class DeviceCache:
    """The handle of a CUDA state: its own copy of the state's tensors
    (cloned once, when it opens, so the caller's state stays valid),
    updated in place by one ``cache_replay`` or ``cache_ops`` launch per
    call, with no host sync.  Hit counts come back as device tensors,
    int32 [1].  :meth:`state` hands those tensors to the state it returns,
    with no second copy, and closes the handle."""

    def __init__(self, st: CacheState):
        self.policy = st.policy
        self.device = st.status.device
        self.tables = tuple(getattr(st, n).clone() for n in TABLES)

    def state(self) -> CacheState:
        tables, self.tables = self.tables, None
        if tables is None:
            raise RuntimeError("DeviceCache: state() was already taken")
        return CacheState(self.policy, **dict(zip(TABLES, tables)))

    def _pages(self, pages) -> torch.Tensor:
        if isinstance(pages, torch.Tensor):
            return pages.reshape(-1).to(self.device, torch.int32).contiguous()
        return torch.tensor(_page_list(pages), dtype=torch.int32,
                            device=self.device)

    def replay(self, traces: torch.Tensor) -> torch.Tensor:
        return kernel_ops.cache_replay(
            self.policy, self.tables, traces.to(torch.int32).contiguous())

    def access(self, pages) -> torch.Tensor:
        return kernel_ops.cache_ops(self.policy, self.tables,
                                    self._pages(pages), kind=ACCESS)

    def invalidate(self, pages) -> None:
        kernel_ops.cache_ops(self.policy, self.tables, self._pages(pages),
                             kind=INVALIDATE)

    def priority_admit(self, pages) -> None:
        kernel_ops.cache_ops(self.policy, self.tables, self._pages(pages),
                             kind=PRIORITY_ADMIT)

    def apply(self, pages: torch.Tensor, kinds: torch.Tensor) -> torch.Tensor:
        return kernel_ops.cache_ops(self.policy, self.tables,
                                    self._pages(pages),
                                    kinds.to(self.device,
                                             torch.int8).contiguous())


Handle = DeviceCache | HostCache


def open(st: CacheState) -> Handle:  # noqa: A001
    """A handle that advances a copy of ``st``: on the card through the
    cache kernels, on the CPU through the host state machine."""
    return DeviceCache(st) if st.status.is_cuda else HostCache(st)


def apply_traces(st: CacheState, traces: torch.Tensor
                 ) -> tuple[torch.Tensor, CacheState]:
    """Replay traces ``[Q, T]`` (int, -1-padded, valid entries a prefix of
    each row) in wave order; returns (replay hit count, int32 [1] on the
    state's device; new state).  The merged state evolves exactly as if
    the accesses had been issued one after another."""
    cache = open(st)
    hits = cache.replay(traces)
    return hits, cache.state()


def apply_trace(st: CacheState, trace: torch.Tensor
                ) -> tuple[torch.Tensor, CacheState]:
    """Replay one trace ``[T]``."""
    return apply_traces(st, trace[None])


def priority_admit(st: CacheState, page) -> CacheState:
    """The entrance-aware admit of ``page`` (skipped if -1) on a packed
    state (NAVIS policy only)."""
    if st.policy != POLICIES["navis"]:
        return st
    cache = open(st)
    cache.priority_admit(page)
    return cache.state()


def invalidate_pages(st: CacheState, pages) -> CacheState:
    """Apply the eviction hint to each page id in ``pages``, in order (-1
    skipped)."""
    if st.policy == POLICIES["none"] or len(pages) == 0:
        return st
    cache = open(st)
    cache.invalidate(pages)
    return cache.state()


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
