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
raises.  A *counting* virtual mesh (``counting=True``) runs the program
of rank 0 instead: every ``axis_index`` is 0, so every ceiling block is
rank 0's, and each collective is counted as a real one would be and
returns a tensor of the shape the real one gives (on meta tensors, where
``launch.step_analysis`` runs a step).  Its counts are one device's, as
the reference's partitioned HLO is the one program every device runs.

Placement (``shard_tree`` with ``transformer.param_specs``, defined in
``models/layers.py`` and reached here): a rank holds its batch rows
(``batch_specs``) and its block of every parameter leaf by the
reference's specs (FSDP over ``data``, tensor-parallel columns or rows,
the embedding's vocabulary rows and the experts over ``model``); the
layers gather a leaf's blocks on use (``layers`` "Sharding") and drop the
gathered copy after.  ``interop.params_from`` followed by ``shard_tree``
carries the reference's weights to a rank.

Under autograd (training over a mesh) the collectives differentiate as
the reference's ``shard_map`` transposes them: ``all_gather``'s backward
is a sum-scatter over the same group, and ``sum_scatter``'s (a
row-parallel product's partials summed and cut along the sequence) an
all-gather; ``sum_partials`` (a ``psum`` of partials that every rank of
the group then uses alike, as the loss and the Mamba mixer's dt, B and
C) passes its cotangent through, and ``share`` (a gather whose result
every rank then uses alike, as the vocabulary-parallel loss's maxima and
sums) takes this rank's slice of it; ``enter`` (a value held alike by
the group entering work split over it, as those dt, B and C entering
the mixer's channel blocks) sums the ranks' partial cotangents.
``all_reduce`` itself writes in place and is not differentiable.

Every collective names its ``part`` (a required keyword), and ``Mesh.parts`` counts calls and
bytes by part (a backward's under its forward's part), ``Mesh.kinds`` by
the reference HLO's kind (``KINDS``: a gather is an ``all-gather``, a
sum-scatter a ``reduce-scatter``, a sum an ``all-reduce``): ``fsdp`` (leaves
gathered over ``rules.fsdp``), ``tp`` (leaves gathered over
``rules.tensor``, and the decode's row-parallel sums), ``sp`` (the
residual's sequence gathers and sum-scatters over ``rules.act_seq``),
``vocab`` (the embedding's sums, the loss's maxima and sums, the logits'
gathers), ``decode_seq`` (the decode attention's partials over
``rules.seq``), ``moe``, ``loss`` (the loss summed over the batch axes),
``grad`` (the train step's gradient sums) and ``opt`` (the optimizer's
norms and means).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os

import torch
import torch.distributed as dist

from repro_torch import trips
from repro_torch.models.layers import P, ShardingRules
# the placement helpers live beside P (checkpoint/ and train/ use them
# too); the mesh's users reach them here
from repro_torch.models.layers import shard_tree  # noqa: F401

STATS = ("calls", "bytes", "backward_calls", "backward_bytes")
PARTS = ("fsdp", "tp", "sp", "vocab", "decode_seq", "moe", "loss", "grad",
         "opt")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def new_kinds() -> dict:
    """Zero counts by kind, ``{kind: {"calls", "bytes"}}``."""
    return {k: {"calls": 0, "bytes": 0} for k in KINDS}


def kind_record(kinds: dict) -> dict:
    """Counts by kind as the reference's ``parse_collectives`` returns
    them: ``{"bytes_by_kind": {kind: bytes, "total"}, "op_counts":
    {kind: calls}}``."""
    by_kind = {k: kinds[k]["bytes"] for k in KINDS}
    by_kind["total"] = sum(by_kind.values())
    return {"bytes_by_kind": by_kind,
            "op_counts": {k: kinds[k]["calls"] for k in KINDS}}


class Mesh:
    """Named axes over a ``torch.distributed`` world (or, ``virtual``,
    over none).

    ``shape``: the axis sizes in order, as ``jax``'s ``mesh.shape`` reads;
    ``coords``: this rank's coordinate on each axis (None when virtual;
    all 0 when ``counting``).  ``stats`` counts the collectives this rank
    issued (``calls``) and the bytes it handed them (``bytes``: each
    call's input); those issued by a backward are counted there too, and
    apart in ``backward_calls`` and ``backward_bytes``; ``parts`` counts
    both by the collective's part (``PARTS``), ``{part: {"calls",
    "bytes"}}``; ``kinds`` counts calls and the bytes of their results
    (twice that for an all-reduce, which moves about twice its payload
    on a ring) by kind (``KINDS``), as the reference's HLO analysis
    reads them.  A counting mesh scales every count by
    ``trips.multiplier()``.  ``reset_stats`` zeroes them all.  ``trace``,
    where set, is called with (kind, part, result bytes) of every
    collective counted."""

    def __init__(self, shape: dict[str, int], *, group=None,
                 virtual: bool = False, counting: bool = False):
        if counting and not virtual:
            raise ValueError("a counting mesh is virtual")
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.counting = counting
        self.trace = None
        self.reset_stats()
        self.coords = dict.fromkeys(self.axis_names, 0) if counting else None
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
        kind = ("counting " if self.counting else
                "virtual " if self.coords is None else "")
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
        if not self.counting:
            self._group((axis,))
        return self.coords[axis]

    def flat_index(self, axes) -> int:
        """This rank's flattened index over ``axes``, the first major."""
        flat = 0
        for a in self._axes(axes):
            flat = flat * self.shape[a] + self.axis_index(a)
        return flat

    def reset_stats(self) -> None:
        self.stats = dict.fromkeys(STATS, 0)
        self.parts = {}
        self.kinds = new_kinds()

    def group_size(self, axes) -> int:
        """The number of ranks over ``axes`` (a name, a tuple; None entries
        dropped)."""
        return math.prod(self.shape[a]
                         for a in self._axes(axes, any_order=True))

    def _count(self, x: torch.Tensor, part: str, kind: str, out_numel: int,
               backward: bool = False) -> None:
        """One collective handed ``x`` whose result has ``out_numel``
        elements."""
        if part not in PARTS:
            raise ValueError(f"unknown collective part {part!r}")
        times = trips.multiplier() if self.counting else 1
        n = x.numel() * x.element_size()
        wire = out_numel * x.element_size() * (2 if kind == "all-reduce"
                                               else 1)
        self.stats["calls"] += times
        self.stats["bytes"] += n * times
        if backward:
            self.stats["backward_calls"] += times
            self.stats["backward_bytes"] += n * times
        by = self.parts.setdefault(part, {"calls": 0, "bytes": 0})
        by["calls"] += times
        by["bytes"] += n * times
        self.kinds[kind]["calls"] += times
        self.kinds[kind]["bytes"] += wire * times
        if self.trace is not None:
            self.trace(kind, part, wire * times)

    def _gather(self, x, axes, dim: int, part: str,
                backward: bool = False) -> torch.Tensor:
        group = None if self.counting else self._group(axes)
        n = math.prod(self.shape[a] for a in axes)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        self._count(x, part, "all-gather", out.numel(), backward)
        if group is not None:
            dist.all_gather_into_tensor(out, x, group=group)
        if dim == 0:
            return out
        out = out.view((n,) + tuple(x.shape)).movedim(0, dim)
        return out.reshape(x.shape[:dim] + (n * x.shape[dim],) +
                           x.shape[dim + 1:])

    def _sum_scatter(self, g, axes, dim: int, part: str,
                     backward: bool = False) -> torch.Tensor:
        """The transpose of ``_gather``: ``g`` cut along ``dim`` into the
        group's blocks in group order, each block summed over the group;
        this rank's block."""
        group = None if self.counting else self._group(axes)
        n = math.prod(self.shape[a] for a in axes)
        if g.shape[dim] % n:
            raise ValueError(f"a sum-scatter of dim {dim} of {g.shape[dim]} "
                             f"over {axes} of {n} ranks")
        g = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
        g = g.contiguous()
        out = g.new_empty(g.shape[1:])
        self._count(g, part, "reduce-scatter", out.numel(), backward)
        if group is not None:
            dist.reduce_scatter_tensor(
                out, g.reshape((-1,) + tuple(g.shape[2:])), group=group)
        return out

    def _sum(self, x, axes, part: str,
             backward: bool = False) -> torch.Tensor:
        group = None if self.counting else self._group(axes)
        self._count(x, part, "all-reduce", x.numel(), backward)
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0, *,
                   part: str) -> torch.Tensor:
        """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the ranks'
        ``x`` concatenated along ``dim`` in group order.  No axes: x.
        Under autograd its backward sums the cotangent over the group and
        scatters it back (``reduce_scatter_tensor``, same order)."""
        axes = self._axes(axes)
        if not axes:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Gather.apply(x, self, axes, dim, part)
        return self._gather(x, axes, dim, part)

    def share(self, x: torch.Tensor, axes, dim: int = 0, *,
              part: str) -> torch.Tensor:
        """:meth:`all_gather` of values whose gathered whole every rank of
        the group then uses identically (the vocabulary-parallel loss's
        maxima and sums): under autograd the backward takes this rank's
        slice of the cotangent, with no collective."""
        axes = self._axes(axes)
        if not axes:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Share.apply(x, self, axes, dim, part)
        return self._gather(x, axes, dim, part)

    def sum_scatter(self, x: torch.Tensor, axes, dim: int, *,
                    part: str) -> torch.Tensor:
        """Partials summed over the group and cut along ``dim`` into its
        blocks in group order; this rank's block (``psum_scatter(...,
        tiled=True)``, the dim a multiple of the group's size).  Under
        autograd the backward all-gathers the cotangent.  No axes: x."""
        axes = self._axes(axes)
        if not axes:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _SumScatter.apply(x, self, axes, dim, part)
        return self._sum_scatter(x, axes, dim, part)

    def all_reduce(self, x: torch.Tensor, axes, *,
                   part: str) -> torch.Tensor:
        """``lax.psum(x, axes)``, in place on ``x`` (returned).  No
        axes: x.  Not differentiable: under autograd use
        :meth:`sum_partials` or :meth:`enter`."""
        axes = self._axes(axes, any_order=True)
        if not axes:
            return x
        return self._sum(x, axes, part)

    def sum_partials(self, x: torch.Tensor, axes, *,
                     part: str) -> torch.Tensor:
        """``psum`` of partials whose sum every rank of the group then uses
        identically (Megatron's ``g``): under autograd the forward sums a
        copy and the backward passes the cotangent through (each rank's
        cotangent is already the whole one); without it, ``x`` is summed
        in place, as :meth:`all_reduce`.  No axes: x."""
        axes = self._axes(axes, any_order=True)
        if not axes:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _SumPartials.apply(x, self, axes, part)
        return self._sum(x, axes, part)

    def enter(self, x: torch.Tensor, axes, *,
              part: str) -> torch.Tensor:
        """The counterpart of :meth:`sum_partials` where a value held
        identically by the group enters work split over it (Megatron's
        ``f``): the forward is the identity, the backward sums the ranks'
        partial cotangents (on a copy).  No axes, or no autograd: x."""
        axes = self._axes(axes, any_order=True)
        if not axes or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _Enter.apply(x, self, axes, part)


class _Gather(torch.autograd.Function):
    """``Mesh.all_gather`` with its backward: a sum-scatter over the same
    group, in the same rank order."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, part):
        ctx.mesh, ctx.axes, ctx.dim, ctx.part = mesh, axes, dim, part
        return mesh._gather(x, axes, dim, part)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._sum_scatter(g, ctx.axes, ctx.dim, ctx.part,
                                      backward=True), None, None, None,
                None)


class _Share(torch.autograd.Function):
    """``Mesh.share``: a gather whose backward is this rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, part):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.at = mesh.flat_index(axes) * x.shape[dim]
        return mesh._gather(x, axes, dim, part)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at, ctx.n), None, None, None, None


class _SumScatter(torch.autograd.Function):
    """``Mesh.sum_scatter`` with its backward: an all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, part):
        ctx.mesh, ctx.axes, ctx.dim, ctx.part = mesh, axes, dim, part
        return mesh._sum_scatter(x, axes, dim, part)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._gather(g, ctx.axes, ctx.dim, ctx.part,
                                 backward=True), None, None, None, None)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, part):
        return mesh._sum(x.clone(), axes, part)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, part):
        ctx.mesh, ctx.axes, ctx.part = mesh, axes, part
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._sum(g.clone(), ctx.axes, ctx.part, backward=True),
                None, None, None)


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
    rules = ShardingRules(batch=b, tensor="model", fsdp="data",
                          moe_gather_weights=False)
    return dataclasses.replace(rules, seq=rules.cache_seq(mesh))


def batch_specs(mesh, rules: ShardingRules, input_tree):
    """Specs of a step's data inputs (tokens, the cross source, pos):
    ``pos`` whole, anything else over ``rules.batch`` on its first dim."""
    def spec(name, x):
        if name == "pos":
            return P()
        return P(rules.batch, *([None] * (x.dim() - 1)))
    return {k: spec(k, v) for k, v in input_tree.items()}
