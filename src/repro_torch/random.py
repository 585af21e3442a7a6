"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

Answers to the ``jax.random`` calls the reference makes (``cache.py``,
``engine.py``, ``pq.py``, ``graph.py``, ``entrance.py``), as jax 0.9.0
computes them with ``jax_threefry_partitionable=True`` (its default).  A
key is an int64 tensor ``[2]`` holding two uint32 words; torch's uint32
support is thin, so every word lives in int64 and is masked with
``& 0xFFFFFFFF`` after each add and shift.

The hash itself (:func:`threefry2x32`) uses only ``+ ^ << >> &``, so it
runs unchanged on Python ints — the host-side cache replay draws its
eviction probes that way, without a tensor round trip.

Integer draws follow ``jax.random.randint`` for 32-bit dtypes (the
reference's dtype with x64 off); spans must stay below 2**31.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of counter words (x1, x2) under key
    (k1, k2).  Works elementwise on int64 tensors or on Python ints."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1  # rotate left
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words
    (on the host unless ``device`` is given; the functions that take a
    key move it to their own device)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor):
    return key[..., 0], key[..., 1]


def _counters(n: int, device):
    """The partitionable iota: high words 0, low words 0..n-1."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> int64 ``[num, 2]``."""
    k1, k2 = _words(key)
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    k1, k2 = _words(key)
    hi = torch.zeros((1,), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, hi, hi + (int(data) & MASK))
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 raw bits per element (int64 holding uint32), as
    ``jax.random.bits(key, shape, uint32)``."""
    shape = tuple(shape)
    n = math.prod(shape)
    k1, k2 = _words(key)
    hi, lo = _counters(n, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` -> int64."""
    span = max(int(maxval) - int(minval), 1)
    assert span < 2 ** 31, span
    k_hi, k_lo = split(key)
    higher = random_bits(k_hi, shape)
    lower = random_bits(k_lo, shape)
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    # uint32 arithmetic, wrapping as jax's does
    off = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
    off = off % span
    return off + int(minval)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: stable sorts by fresh random
    keys, ``ceil(3 ln n / ln(2**32 - 1))`` rounds."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape, replace: bool = True
           ) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` with uniform weights."""
    shape = tuple(shape)
    if replace:
        return randint(key, shape, 0, n)
    return permutation(key, n)[:math.prod(shape)].reshape(shape)


# -- the same draws on a key held as two Python ints (host-side replay) ----

def split_ints(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """:func:`split` on a ``(k1, k2)`` pair of Python ints."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def randint_ints(key: tuple[int, int], n: int, minval: int,
                 maxval: int) -> list[int]:
    """:func:`randint` of shape ``(n,)`` on a ``(k1, k2)`` pair of ints."""
    span = max(int(maxval) - int(minval), 1)
    assert span < 2 ** 31, span
    k_hi, k_lo = split_ints(key)
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    out = []
    for i in range(n):
        a, b = threefry2x32(k_hi[0], k_hi[1], 0, i)
        c, d = threefry2x32(k_lo[0], k_lo[1], 0, i)
        off = ((((a ^ b) % span) * mult & MASK) + (c ^ d) % span) & MASK
        out.append(off % span + int(minval))
    return out
