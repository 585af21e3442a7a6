"""The cache replay kernel's resident map (``kernels/csrc/cache_replay.cu``)
modelled on the host: its two buckets a page, and the displacement walk
that places a page when both are full.

The walk once took its slots in a fixed turn (move n into slot ``n & 3``),
which made it a function of the map alone; on some maps it circled among
a few full buckets until the kernel's trap, an ``unspecified launch
failure``.  It now takes the slot ``kick_slot`` hashes from the page in
hand and the move.  ``cache_map_traps.json`` holds three maps of one
FineWeb-like search wave's replay (768-d, 20,000 vectors, ``navis``, 256
cache pages, 107 buckets), each as it stood when the fixed turn trapped:
the same replay, from maps the kernel's parallel prologue built in three
different orders.  The model reads the kernel's constants from its
source, so a change there shows here.
"""
from __future__ import annotations

import json
import random
import re
from pathlib import Path

import pytest

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
      "kernels" / "csrc" / "cache_replay.cu").read_text()
TRAPS = json.loads(Path(__file__).with_name("cache_map_traps.json")
                   .read_text())
EMPTY = -1
U32 = 0xFFFFFFFF


def _body(name: str) -> str:
    """The source of the kernel's device function ``name``."""
    m = re.search(r"\b" + name + r"\([^)]*\)\s*\{(.*?)\n\}", CU, re.S)
    assert m, name
    return m.group(1)


def _hex(text: str) -> list[int]:
    return [int(h, 16) for h in re.findall(r"0x([0-9A-Fa-f]+)u", text)]


MUL1, = _hex(_body("map_bucket1"))
MUL2, = _hex(_body("map_bucket2"))
KICK_PAGE, KICK_N, KICK_MIX = _hex(_body("kick_slot"))
MAX_KICKS = int(re.search(r"kMaxKicks = (\d+);", CU).group(1))


def n_buckets(r: int) -> int:
    return max((5 * r + 11) // 12, 2)


def bucket1(page: int, nb: int) -> int:
    return (((page * MUL1) & U32) * nb) >> 32


def bucket2(page: int, nb: int) -> int:
    a = bucket1(page, nb)
    b = (((page * MUL2) & U32) * nb) >> 32
    return b if b != a else (0 if a + 1 == nb else a + 1)


def kick_slot(page: int, n: int) -> int:
    h = (page * KICK_PAGE + n * KICK_N) & U32
    h ^= h >> 15
    return ((h * KICK_MIX) & U32) >> 30


def fixed_turn(page: int, n: int) -> int:
    return n & 3


def displace(keys: list, nb: int, page: int, slot_of, trail=None):
    """The kernel's ``displace`` on ``keys`` (in place): the moves it took
    to place ``page``, or None where it would trap.  Where ``trail`` is a
    list, each move appends where the walk stood before it: the map, the
    bucket, the page in hand and the turn."""
    b = bucket1(page, nb)
    for n in range(MAX_KICKS):
        if trail is not None:
            trail.append((tuple(keys), b, page, n & 3))
        slot = 4 * b + slot_of(page, n)
        keys[slot], page = page, keys[slot]
        b = bucket2(page, nb) if b == bucket1(page, nb) else \
            bucket1(page, nb)
        if EMPTY in keys[4 * b:4 * b + 4]:
            keys[4 * b + keys[4 * b:4 * b + 4].index(EMPTY)] = page
            return n + 1
    return None


def insert(keys: list, nb: int, page: int, slot_of=kick_slot):
    """The kernel's insert: the first free slot of the page's buckets,
    else the walk.  The moves the walk took (0 without one), or None."""
    for b in (bucket1(page, nb), bucket2(page, nb)):
        if EMPTY in keys[4 * b:4 * b + 4]:
            keys[4 * b + keys[4 * b:4 * b + 4].index(EMPTY)] = page
            return 0
    return displace(keys, nb, page, slot_of)


def assert_sound(keys: list, nb: int, pages: set) -> None:
    """Each page once, in one of its two buckets."""
    held = [k for k in keys if k != EMPTY]
    assert sorted(held) == sorted(pages)
    for s, k in enumerate(keys):
        if k != EMPTY:
            assert s >> 2 in (bucket1(k, nb), bucket2(k, nb))


def test_model_reads_the_kernel():
    assert (MUL1, MUL2) == (0x9E3779B1, 0x85EBCA77)
    assert MAX_KICKS == 1024
    assert "(5 * R + 11) / 12" in CU
    assert "4 * b + kick_slot(page, n)" in _body("displace")
    assert "h ^= h >> 15" in _body("kick_slot")
    assert ">> 30" in _body("kick_slot")
    assert TRAPS["nb"] == n_buckets(256)


@pytest.mark.parametrize("m", range(len(TRAPS["maps"])))
def test_fixed_turn_circles_on_the_saved_maps(m):
    nb, saved = TRAPS["nb"], TRAPS["maps"][m]
    keys, page = list(saved["keys"]), saved["page"]
    for b in (bucket1(page, nb), bucket2(page, nb)):
        assert EMPTY not in keys[4 * b:4 * b + 4]
    trail = []
    assert displace(keys, nb, page, fixed_turn, trail) is None
    # it stands where it stood before within a few moves, and so forever
    first = trail.index(trail[64])
    assert first < 64 and len(set(trail[:64])) < 64


@pytest.mark.parametrize("m", range(len(TRAPS["maps"])))
def test_kick_slot_places_the_page_on_the_saved_maps(m):
    nb, saved = TRAPS["nb"], TRAPS["maps"][m]
    keys, page = list(saved["keys"]), saved["page"]
    before = {k for k in keys if k != EMPTY}
    moves = displace(keys, nb, page, kick_slot)
    assert moves is not None and moves <= 16
    assert_sound(keys, nb, before | {page})


def test_kick_slot_never_traps_at_the_maps_limit():
    """Maps of 256 residents (60% of 107 buckets of 4), built in random
    orders and then churned as the replay churns them (a resident leaves,
    a new page comes): the walk places every page."""
    rng = random.Random(27)
    nb, walks = n_buckets(256), 0
    for _ in range(16):
        keys = [EMPTY] * (4 * nb)
        pages = set(rng.sample(range(366_000), 256))
        for p in pages:
            moves = insert(keys, nb, p)
            assert moves is not None
            walks += moves > 0
        for _ in range(1_000):
            out = rng.choice(sorted(pages))
            keys[keys.index(out)] = EMPTY
            pages.discard(out)
            new = rng.randrange(366_000)
            while new in pages:
                new = rng.randrange(366_000)
            moves = insert(keys, nb, new)
            assert moves is not None
            walks += moves > 0
            pages.add(new)
        assert_sound(keys, nb, pages)
    assert walks > 0
