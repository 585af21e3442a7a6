"""The port's host-clock record of an engine call: spans, the host's reads
of device values, and host counters.

``Engine.search_many`` opens the root :class:`span` ``search_many``, its
stages open child spans inside it, and it hands the wave's record out in
``last_wave_timing``.  ``insert_many``'s and the maintenance pass's
stages are spans too, read by their ``seconds``.  A span opened while
none is open starts a new record with a new wave id, so nothing
accumulates from one call to the next; :func:`take` hands the record out
and clears it.

:func:`read` is the one way the search path turns a device tensor into a
host ``bool`` / ``int``.  Such a read blocks the host until the device
has run everything queued before it, so it is stamped before and after,
and its count and the nanoseconds the host was blocked add up under
``"<stage>/<site>"``, the stage being the innermost open span (empty
outside any span).  :func:`sync` does the same for an explicit wait on
the device, under the site ``timing``.  :func:`count` adds to a host
counter.

Stamps are ``time.perf_counter_ns()``, the clock of the benchmark's host
spans; a record gives them in ``perf_counter`` seconds.  The recorder
issues no device work and no sync of its own, and costs a few hundred
nanoseconds of host time a span or a read, so it has no switch.  Each
thread keeps its own record.
"""
from __future__ import annotations

import itertools
import threading
from time import perf_counter_ns as _clock
from typing import NamedTuple

import torch

_waves = itertools.count(1)


class Span(NamedTuple):
    """A closed span, in ``perf_counter`` seconds; ``parent`` is the name
    of the span it opened in (None for the root)."""
    wave: int
    name: str
    parent: str | None
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _Record(threading.local):
    """One thread's record: the innermost open span, the closed ones as
    ``(name, parent, t0_ns, t1_ns)``, reads as ``{stage: {site: [count,
    blocked_ns]}}`` with ``cur`` the open stage's, and counters."""

    def __init__(self):
        self.wave = 0
        self.open: span | None = None
        self.clear()

    def clear(self) -> None:
        self.spans: list[tuple] = []
        self.reads: dict[str, dict] = {"": {}}
        self.cur: dict = self.reads[""]
        self.counts: dict[str, int] = {}


_rec = _Record()


class span:  # noqa: N801 - used as a statement: ``with span("lut"):``
    """A named stage: ``with span(name) as s:``; ``s.seconds`` after it.
    Opened with no span open, it is a root: a new record begins."""

    __slots__ = ("name", "outer", "saved", "t0", "t1")

    def __init__(self, name: str):
        self.name = name
        self.outer = None
        self.t0 = self.t1 = 0

    @property
    def parent(self) -> str | None:
        return None if self.outer is None else self.outer.name

    def __enter__(self) -> "span":
        rec = _rec
        self.outer = rec.open
        if self.outer is None:
            rec.wave = next(_waves)
            rec.clear()
        self.saved = rec.cur
        rec.open = self
        rec.cur = rec.reads.setdefault(self.name, {})
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = _clock()
        rec = _rec
        rec.open, rec.cur = self.outer, self.saved
        rec.spans.append((self.name, self.parent, self.t0, self.t1))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def _note(site: str, ns: int) -> None:
    r = _rec.cur.get(site)
    if r is None:
        _rec.cur[site] = [1, ns]
    else:
        r[0] += 1
        r[1] += ns


def read(x: torch.Tensor, site: str):
    """``x``'s one value as a host ``bool`` / ``int`` / ``float``, the
    wait for it recorded under ``site``."""
    t0 = _clock()
    v = x.item()
    _note(site, _clock() - t0)
    return v


def sync(t: torch.Tensor) -> None:
    """Wait for the card's queued work on ``t``'s device (nothing to wait
    for on the CPU), so that a host clock around a stage measures the
    stage; recorded as a read at the site ``timing``."""
    t0 = _clock()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    _note("timing", _clock() - t0)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    c = _rec.counts
    c[name] = c.get(name, 0) + n


def take() -> dict:
    """The record so far, and clear it: ``wave`` (its id), ``spans`` (each
    closed :class:`Span`, in closing order), ``reads`` (``{"<stage>/<site>":
    [count, blocked_s]}``) and ``counts``."""
    rec = _rec
    out = {"wave": rec.wave,
           "spans": [Span(rec.wave, n, p, t0 * 1e-9, t1 * 1e-9)
                     for n, p, t0, t1 in rec.spans],
           "reads": {f"{stage}/{site}": [n, ns * 1e-9]
                     for stage, sites in rec.reads.items()
                     for site, (n, ns) in sites.items()},
           "counts": dict(rec.counts)}
    rec.clear()
    return out
