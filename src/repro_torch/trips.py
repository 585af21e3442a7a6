"""Loops whose iterations repeat the same work, for a step analysis to run
one and multiply (no reference counterpart: XLA's while loops are what
``repro/launch/hlo_analysis.py`` multiplies by their trip counts).

The port writes its stacks and scans as Python loops: the layers of a
stage, the selective scan's chunks and time steps, the optimizer's stack
slices.  On meta tensors, where only shapes exist, iterations of equal
shapes issue the same operations and the same collectives, so
``launch.step_analysis`` counts one and multiplies it out.  Outside an
analysis that multiplies (every run that computes), :func:`each` yields
every item with a count of 1 and :func:`enter` / :func:`leave` return
their argument: nothing changes.

Inside one (:func:`collapsing`), :func:`each` groups the items by ``key``
and yields the first item of each group with the group's size ``n``;
while the caller's body runs for it, :func:`multiplier` is scaled by
``n``, and the analysis's counters (and a counting mesh's) scale what
they count by it.  A body's backward runs later, outside the loop:
:func:`enter` and :func:`leave` around the body (identities) scale the
multiplier between them in the backward as well.  What a body leaves
behind must have the shape all ``n`` iterations would have given it (a
list of per-iteration outputs gets ``n`` entries).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator

import torch

_state = {"collapse": False, "mult": 1, "max_trip": 1}


def multiplier() -> int:
    """How many iterations the work being issued now stands for."""
    return _state["mult"]


def is_collapsing() -> bool:
    return _state["collapse"]


def max_trip() -> int:
    """The largest group :func:`each` multiplied out since
    :func:`collapsing` began (1 when nothing was)."""
    return _state["max_trip"]


@contextlib.contextmanager
def collapsing(on: bool = True):
    """Within the block (``on``), loops written with :func:`each` run one
    iteration per group and scale the multiplier by the group's size.
    Only for meta tensors: the values a collapsed loop computes are not
    those of the whole loop."""
    saved = dict(_state)
    _state.update(collapse=on, mult=1, max_trip=1)
    try:
        yield
    finally:
        _state.update(saved)


def _scale(n: int) -> None:
    _state["mult"] *= n


def _unscale(n: int) -> None:
    _state["mult"] //= n


def each(items: Iterable, key: Callable = lambda item: None
         ) -> Iterator[tuple[object, int]]:
    """``(item, 1)`` for every item; collapsing, ``(first item, n)`` for
    every group of items of equal ``key`` (in order of first appearance),
    the multiplier scaled by ``n`` until the next item is asked for."""
    if not _state["collapse"]:
        for item in items:
            yield item, 1
        return
    groups: dict = {}
    for item in items:
        groups.setdefault(key(item), []).append(item)
    for group in groups.values():
        n = len(group)
        _state["max_trip"] = max(_state["max_trip"], n)
        _scale(n)
        try:
            yield group[0], n
        finally:
            _unscale(n)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _unscale(ctx.n)
        return g, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _scale(ctx.n)
        return g, None


def enter(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` entering a body that stands for ``n`` iterations: in the
    backward (which reaches it after the body's) the multiplier is scaled
    back.  ``n`` 1 or no autograd: ``x``."""
    if n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Enter.apply(x, n)


def leave(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` leaving such a body: in the backward the multiplier is
    scaled by ``n`` until :func:`enter`'s backward."""
    if n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Leave.apply(x, n)
