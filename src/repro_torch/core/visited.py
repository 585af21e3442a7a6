"""O(1)-state visited sets for graph traversals, one per lane (port of
``repro/core/visited.py``).

:class:`HashVisited` is a fixed-capacity open-addressing (linear probing)
hash set: a power-of-two table of int32 keys (-1 = empty), sized to 2x the
traversal's exact mark bound, with Fibonacci hashing.  The port carries a
leading lane dimension ``[B, table]``; each lane's set evolves exactly as
the reference's does for the same key stream: the same probe order, so
the same tables, counts and overflow counts.

Probing is batched: a lane's probe sequence for one key reads a chunk of
consecutive slots at once and stops at the first hit or empty slot, which
is what the reference's slot-by-slot loop finds, since the table does not
change while one key probes.  One chunk almost always settles every lane
(load factor <= 0.5), so :func:`add` probes all keys of a call at once,
checks once, and redoes the call key by key (the reference's order) only
where the shortcut could differ.  Lanes run in parallel.

:class:`DenseVisited` is the reference's bitmap behind the same
``contains`` / ``add`` API, one ``[n]`` row per lane: the
``visited_impl="bitmap"`` ablation, and the raw page buffer a merge seeds
its inserts' traversals with.  It never overflows.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device

_FIB = 2654435761          # 2^32 / golden ratio (Fibonacci hash)
_CHUNK = 16


@dataclasses.dataclass
class HashVisited:
    """Open-addressing sets, one per lane."""

    keys: torch.Tensor         # [B, table] int32, -1 = empty
    count: torch.Tensor        # [B] int32 — live keys
    overflow: torch.Tensor     # [B] int32 — dropped inserts

    @property
    def size(self) -> int:
        return self.keys.shape[1]


@dataclasses.dataclass
class DenseVisited:
    """Bitmaps, one per lane: O(n) state, O(1) ops."""

    bits: torch.Tensor         # [B, n] bool


VisitedSet = DenseVisited | HashVisited


def make_dense(n: int, batch: int, device=None) -> DenseVisited:
    return DenseVisited(bits=torch.zeros((batch, n), dtype=torch.bool,
                                         device=resolve_device(device)))


def table_size(capacity: int) -> int:
    """Power-of-two table >= 2 x capacity (load factor <= 0.5)."""
    cap = max(int(capacity), 1)
    return max(8, 1 << math.ceil(math.log2(2 * cap)))


def make_hash(capacity: int, batch: int, device=None) -> HashVisited:
    device = resolve_device(device)
    return HashVisited(
        keys=torch.full((batch, table_size(capacity)), -1, dtype=torch.int32,
                        device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
        overflow=torch.zeros((batch,), dtype=torch.int32, device=device))


def _hash(keys: torch.Tensor, size: int) -> torch.Tensor:
    """Fibonacci hash into [0, size): the uint32 product's high bits.
    Keys are int32, and negative keys (never members) hash as 0, so the
    product stays below 2**63 in int64."""
    lg = size.bit_length() - 1
    h = (keys.clamp(min=0).long() * _FIB) & 0xFFFFFFFF
    return h >> (32 - lg)


def _probe(table: torch.Tensor, h: torch.Tensor, keys: torch.Tensor,
           j: int, n: int):
    """Slots h+j .. h+j+n-1 of each lane's probe sequence for ``keys``
    ([B, K] or [B]).  Returns (stopped, hit_at_stop, slot_at_stop): whether
    the sequence met the key or an empty slot in this chunk, whether the
    first such slot holds the key, and that slot."""
    size = table.shape[1]
    ar = torch.arange(j, j + n, device=table.device)
    slots = (h[..., None] + ar) & (size - 1)                 # [B, (K,) n]
    v = table.gather(1, slots.reshape(table.shape[0], -1)).reshape(
        slots.shape)
    hit = v == keys[..., None]
    stop = hit | (v < 0)
    first = torch.where(stop, ar - j, n).amin(-1)
    stopped = first < n
    fidx = first.clamp(max=n - 1)[..., None]
    return (stopped, hit.gather(-1, fidx)[..., 0],
            slots.gather(-1, fidx)[..., 0])


def contains(vs: VisitedSet, keys: torch.Tensor) -> torch.Tensor:
    """Membership of ``keys`` [B, K] in each lane's set -> [B, K] bool
    (negative keys, and keys past a bitmap, are never members)."""
    if isinstance(vs, DenseVisited):
        n = vs.bits.shape[1]
        ok = (keys >= 0) & (keys < n)
        return vs.bits.gather(1, keys.clamp(0, n - 1).long()) & ok
    size = vs.size
    h = _hash(keys, size)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    open_ = keys >= 0
    j = 0
    while j < size:
        n = min(_CHUNK, size - j)
        stopped, hit, _ = _probe(vs.keys, h, keys, j, n)
        found |= open_ & stopped & hit
        open_ &= ~stopped
        j += n
        if j < size and not bool(open_.any()):
            break
    return found


def _add_key(table, count, overflow, k, ok) -> None:
    """Insert one key per lane (``k`` [B], where ``ok``), probing slot by
    slot until the key, an empty slot or a whole table's worth (overflow)."""
    size = table.shape[1]
    h = _hash(k, size)
    probing = ok.clone()
    claimed = torch.zeros_like(ok)
    slot = torch.zeros_like(h)
    j = 0
    while j < size:
        n = min(_CHUNK, size - j)
        stopped, hit, s_at = _probe(table, h, k, j, n)
        newly = probing & stopped
        claimed |= newly & ~hit
        slot = torch.where(newly, s_at, slot)
        probing &= ~stopped
        j += n
        if j < size and not bool(probing.any()):
            break
    cur = table.gather(1, slot[:, None])[:, 0]
    table.scatter_(1, slot[:, None],
                   torch.where(claimed, k.to(table.dtype), cur)[:, None])
    count += claimed.to(count.dtype)
    overflow += probing.to(overflow.dtype)


def add(vs: VisitedSet, keys: torch.Tensor, mask: torch.Tensor
        ) -> VisitedSet:
    """Insert ``keys[mask]`` ([B, K] or [B]; idempotent, the keys of a lane
    in order).  A lane whose table is full drops the key and bumps
    ``overflow``.

    All K keys probe the table as it was before the call, one chunk each.
    That is what the serial scan finds unless a key's probe runs past the
    chunk, or two keys of a lane claim the same empty slot: an earlier
    key's claim is an empty slot, and a later key's run ends at its first
    empty slot, so the claim can only meet that run at its end.  Repeats
    of a key within the call find the first copy (or overflow with it).
    If either case occurs in any lane, the call is redone key by key."""
    if keys.dim() == 1:
        keys, mask = keys[:, None], mask[:, None]
    if isinstance(vs, DenseVisited):
        n = vs.bits.shape[1]
        ok = mask & (keys >= 0) & (keys < n)
        # masked keys write their slot's own value (a max of False)
        bits = vs.bits.view(torch.uint8).scatter_reduce(
            1, keys.clamp(0, n - 1).long(), ok.to(torch.uint8), "amax")
        return DenseVisited(bits=bits.view(torch.bool))
    size, k = vs.size, keys.shape[1]
    ok = mask & (keys >= 0)
    ar = torch.arange(k, device=keys.device)
    earlier = ar[None, None, :] < ar[None, :, None]            # [1, K, K]
    repeat = ((keys[:, :, None] == keys[:, None, :]) & ok[:, None, :] &
              earlier).any(2)
    first = ok & ~repeat
    n = min(_CHUNK, size)
    stopped, hit, s_at = _probe(vs.keys, _hash(keys, size), keys, 0, n)
    claim = first & stopped & ~hit
    clash = ((s_at[:, :, None] == s_at[:, None, :]) & claim[:, :, None] &
             claim[:, None, :] & earlier).any(2)
    redo = clash.any() if size <= _CHUNK else \
        (clash | (first & ~stopped)).any()
    if bool(redo):
        table, count = vs.keys.clone(), vs.count.clone()
        ovf = vs.overflow.clone()
        for i in range(k):
            _add_key(table, count, ovf, keys[:, i], ok[:, i])
        return HashVisited(keys=table, count=count, overflow=ovf)
    # claims land on distinct empty (-1) slots; everything else writes -1,
    # which amax leaves unchanged
    table = vs.keys.scatter_reduce(
        1, s_at, torch.where(claim, keys.to(vs.keys.dtype), -1), "amax")
    count = vs.count + claim.sum(1).to(vs.count.dtype)
    # a key that met no copy of itself and no empty slot in the whole table
    # overflows; so does each repeat of it
    ovf = vs.overflow + (ok & ~stopped).sum(1).to(vs.overflow.dtype)
    return HashVisited(keys=table, count=count, overflow=ovf)


def nbytes(vs: VisitedSet) -> int:
    """One lane's state footprint of this set (shape math only)."""
    fields = ((vs.bits,) if isinstance(vs, DenseVisited)
              else (vs.keys, vs.count, vs.overflow))
    return sum(t[0].numel() * t.element_size() for t in fields)


def overflow(vs: VisitedSet) -> torch.Tensor:
    """Dropped inserts per lane (always 0 for a bitmap)."""
    if isinstance(vs, DenseVisited):
        return torch.zeros((vs.bits.shape[0],), dtype=torch.int32,
                           device=vs.bits.device)
    return vs.overflow
