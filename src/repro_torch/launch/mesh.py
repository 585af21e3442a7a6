"""The device mesh and its sharding rules (port of ``repro/launch/mesh.py``).

A :class:`Mesh` names the axes of a ``torch.distributed`` world, ordered
like the reference's (``("data", "model")`` or ``("pod", "data",
"model")``): rank r sits at the row-major coordinates of r over the axis
sizes, the last axis fastest.  For every subset of the axes the
constructor builds one process group per coordinate of the others, on
every rank and in the same order (``new_group`` is collective), so a
collective over any tuple of axes runs in its own group.  Within a group
the ranks follow the flattened index over its axes in mesh order, the
first axis major ("pod-major"), which is the order in which
``lax.all_gather(..., tiled=True)`` concatenates and which
``layers.moe_block`` uses to cut its rows back out.  A collective over an
axis of size 1 still goes through its (one-rank) group.

``make_production_mesh`` is a *virtual* mesh: the 16 x 16 or 2 x 16 x 16
shape the dry-run reads, with no process group; a collective on it
raises.

Placement in this slice (``shard_tree`` with ``ep_specs``): a rank holds
its batch rows (``batch_specs``), its block of each expert leaf by
``transformer.param_specs`` (E over ``model``; D, or F for ``down``, over
``data``) and every other leaf whole.  ``interop.params_from`` followed by
``shard_tree`` carries the reference's weights to a rank.  The dense
leaves' tensor-parallel / FSDP placement by ``param_specs`` is ROADMAP.md
queue 1 item 5.6.
"""
from __future__ import annotations

import itertools
import math
import os

import torch
import torch.distributed as dist

from repro_torch.models.layers import P, ShardingRules, is_spec
from repro_torch.tree import tree_map


class Mesh:
    """Named axes over a ``torch.distributed`` world (or, ``virtual``,
    over none).

    ``shape``: the axis sizes in order, as ``jax``'s ``mesh.shape`` reads;
    ``coords``: this rank's coordinate on each axis (None when virtual).
    ``stats`` counts the collectives this rank issued (``calls``) and the
    bytes it handed them (``bytes``: each call's input)."""

    def __init__(self, shape: dict[str, int], *, group=None,
                 virtual: bool = False):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.stats = {"calls": 0, "bytes": 0}
        self.coords = None
        self._groups = None
        if virtual:
            return
        world = group if group is not None else dist.group.WORLD
        ranks = dist.get_process_group_ranks(world)
        if len(ranks) != self.size:
            raise ValueError(f"a mesh of {self.shape} needs {self.size} "
                             f"ranks, the group has {len(ranks)}")
        sizes = tuple(self.shape.values())
        grid = list(itertools.product(*map(range, sizes)))
        me = grid[ranks.index(dist.get_rank())]
        self.coords = dict(zip(self.axis_names, me))
        self._groups = {}
        for k in range(1, len(sizes) + 1):
            for sub in itertools.combinations(range(len(sizes)), k):
                rest = [i for i in range(len(sizes)) if i not in sub]
                for fixed in itertools.product(*(range(sizes[i])
                                                 for i in rest)):
                    members = [ranks[n] for n, c in enumerate(grid)
                               if all(c[i] == f for i, f in zip(rest, fixed))]
                    g = dist.new_group(members)
                    if all(me[i] == f for i, f in zip(rest, fixed)):
                        if dist.get_process_group_ranks(g) != members:
                            raise ValueError(
                                "the mesh needs its group's ranks in "
                                f"increasing order, got {ranks}")
                        self._groups[tuple(self.axis_names[i]
                                           for i in sub)] = g

    def __repr__(self) -> str:
        kind = "virtual " if self.coords is None else ""
        return f"{kind}Mesh({self.shape})"

    def _axes(self, axes, any_order: bool = False) -> tuple[str, ...]:
        """``axes`` (a name, a tuple, None entries dropped) as a tuple in
        mesh order; given in another order, they raise unless
        ``any_order`` (a sum's result does not depend on it)."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        axes = tuple(a for a in axes if a is not None)
        if any(a not in self.shape for a in axes):
            raise ValueError(f"axes {axes} not all in the mesh {self.shape}")
        ordered = tuple(a for a in self.axis_names if a in axes)
        if ordered != axes and not any_order:
            raise ValueError(f"axes {axes} out of the mesh's order "
                             f"{self.axis_names}")
        return ordered

    def _group(self, axes):
        if self._groups is None:
            raise RuntimeError(f"{self!r} has no process group: a virtual "
                               "mesh runs no collective")
        return self._groups[axes]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        (axis,) = self._axes(axis)
        self._group((axis,))
        return self.coords[axis]

    def flat_index(self, axes) -> int:
        """This rank's flattened index over ``axes``, the first major."""
        flat = 0
        for a in self._axes(axes):
            flat = flat * self.shape[a] + self.axis_index(a)
        return flat

    def _count(self, x: torch.Tensor) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the ranks'
        ``x`` concatenated along ``dim`` in group order.  No axes: x."""
        axes = self._axes(axes)
        if not axes:
            return x
        group = self._group(axes)
        n = math.prod(self.shape[a] for a in axes)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        self._count(x)
        dist.all_gather_into_tensor(out, x, group=group)
        if dim == 0:
            return out
        out = out.view((n,) + tuple(x.shape)).movedim(0, dim)
        return out.reshape(x.shape[:dim] + (n * x.shape[dim],) +
                           x.shape[dim + 1:])

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``lax.psum(x, axes)``, in place on ``x`` (returned).  No
        axes: x."""
        axes = self._axes(axes, any_order=True)
        if not axes:
            return x
        group = self._group(axes)
        self._count(x)
        dist.all_reduce(x, group=group)
        return x


def make_mesh(shape, axes, group=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``group`` (default: the
    default world, NCCL on the card, gloo on the host; the caller
    initialises it)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    return Mesh(dict(zip(axes, shape)), group=group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape, virtual: (data 16, model 16), or
    (pod 2, data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)), virtual=True)


def make_smoke_mesh() -> Mesh:
    """A 1 x 1 mesh with the production axis names on the current world
    (of one rank)."""
    return make_mesh((1, 1), ("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def make_rules(mesh, *, kind: str, global_batch: int,
               cfg=None) -> ShardingRules:
    """Sharding rules for one (shape-kind, batch) cell on a mesh (the
    reference's, field for field).

    train / prefill: batch over (pod, data), TP over model, FSDP over
    data.  decode: batch over (pod, data), the KV caches' sequence over
    model, the MoE weights kept 2-D sharded.  A global batch that does not
    fill the batch axes (long_500k's 1) shards no batch; the decode
    caches' sequence then spreads over every axis.
    """
    baxes = batch_axes(mesh)
    dsize = data_size(mesh)
    if global_batch >= dsize and global_batch % dsize == 0:
        b = baxes if len(baxes) > 1 else baxes[0]
    else:
        b = None
    if kind in ("train", "prefill"):
        # sequence-parallel attention: on when gathering the KV heads costs
        # at most half of gathering the residual
        sp = os.environ.get("REPRO_SP_ATTN", "") == "1"
        if cfg is not None and getattr(cfg, "num_heads", 0):
            sp = sp or (cfg.num_kv_heads * cfg.hd * 2 <= cfg.d_model)
        return ShardingRules(batch=b, tensor="model", fsdp="data", seq=None,
                             act_seq="model", seq_parallel_attn=sp)
    if b is None:
        seq = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    else:
        seq = "model"
    return ShardingRules(batch=b, tensor="model", fsdp="data", seq=seq,
                         moe_gather_weights=False)


def _block(mesh: Mesh, x: torch.Tensor, spec) -> torch.Tensor:
    for dim, ax in enumerate(tuple(spec or ())):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        chunk = -(-x.shape[dim] // n)
        start = min(mesh.flat_index(axes) * chunk, x.shape[dim])
        x = x.narrow(dim, start, min(chunk, x.shape[dim] - start))
    return x


def shard_tree(tree, spec_tree, mesh: Mesh):
    """This rank's block of every leaf of ``tree`` by ``spec_tree`` (the
    same structure, ``layers.P`` or None leaves): a dim split over axes
    of ``n`` ranks in all comes in blocks of ``ceil(dim / n)``, as
    ``dryrun._sharded_bytes`` reckons them (the last one shorter, or
    empty).  Views, no copy.  It stands in for the reference's ``named``
    + ``device_put``."""
    return tree_map(lambda spec, x: _block(mesh, x, spec), spec_tree, tree,
                    is_leaf=is_spec)


def ep_specs(param_specs):
    """The placement of this slice: the MoE leaves' specs as
    ``param_specs`` gives them (the experts' ``up``, ``gate`` and
    ``down``; the router's is whole), every other leaf whole (``P()``)."""
    def walk(node, moe=False):
        if is_spec(node):
            return node if moe else P()
        if isinstance(node, dict):
            return {k: walk(v, moe or k == "moe") for k, v in node.items()}
        return [walk(v, moe) for v in node]
    return walk(param_specs)


def batch_specs(mesh, rules: ShardingRules, input_tree):
    """Specs of a step's data inputs (tokens, the cross source, pos):
    ``pos`` whole, anything else over ``rules.batch`` on its first dim."""
    def spec(name, x):
        if name == "pos":
            return P()
        return P(rules.batch, *([None] * (x.dim() - 1)))
    return {k: spec(k, v) for k, v in input_tree.items()}
