"""Nested-container helpers in JAX's flattening order (no reference
counterpart: the reference uses ``jax.tree_util``).

A tree is nested dicts, lists and tuples; anything else is a leaf.  Dict
keys are visited sorted and lists and tuples by index, as
``jax.tree.leaves`` visits them, whatever order the dicts were built in.
The optimizers' Adafactor state list (one entry per parameter leaf) and
the checkpoint store's leaf names and order rely on it, so a state or a
checkpoint goes across between the two packages leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_flatten_with_path(tree, prefix: tuple = (), is_leaf=None
                           ) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs; a path is the keys and indices down to the
    leaf.  ``is_leaf(node)`` true makes a node a leaf (a spec tree's
    ``P``, a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], prefix + (k,),
                                              is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_path(v, prefix + (i,), is_leaf)
    else:
        yield prefix, tree


def tree_leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree,
                                                       is_leaf=is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (the same structure), in a tree of that structure;
    ``is_leaf`` as in ``tree_flatten_with_path``, applied to ``tree``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in flattening
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)([build(v) for v in node])
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
