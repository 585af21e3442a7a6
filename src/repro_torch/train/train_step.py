"""Train-step builder: loss -> grad -> (optional compression) -> optimizer
(port of ``repro/train/train_step.py``).

Microbatch gradient accumulation (a Python loop where the reference
scans) and optional bf16 gradient compression with error feedback.  The
gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (set to require grad); the optimizer then adds its updates to the
parameters in place, under ``torch.no_grad``, one stack slice at a time
(``Optimizer.apply``), and writes its state in place.

Over a mesh (``rules`` / ``mesh``, the reference's arguments, the train
rules' sequence parallelism on) each rank holds its batch rows and its
block of every parameter leaf by ``param_specs`` (``layers.shard_tree``);
the layers gather a leaf's blocks on use, and the gathers' backward hands
back gradient blocks.  After ``autograd.grad`` each rank's gradient leaf
is a partial that ``_reduce_grads`` finishes through the mesh, so that it
equals the reference's ``jax.grad`` leaf cut to the rank's block; the
optimizer's global reductions then go through the mesh too
(``optimizer.Placement``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import NO_SHARD, is_spec
from repro_torch.train.optimizer import Optimizer, Placement
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

def make_loss_fn(cfg: T.ModelConfig, *, rules=NO_SHARD, mesh=None):
    def loss_fn(params, batch):
        return T.lm_loss(cfg, params, batch["tokens"],
                         cross_src=batch.get("cross_src"), rules=rules,
                         mesh=mesh)
    return loss_fn


def _grad_axes(cfg, rules, place: Placement) -> list[tuple[tuple, float]]:
    """For each parameter leaf (flattening order), the mesh axes its
    gradient is summed over and the factor it is scaled by.

    The rule, for every leaf alike: summed over the mesh axes its spec
    does not name, then scaled by 1 / the size of the batch axes that
    split no rows (``rules.batch`` None: a global batch that fills no
    batch axis).  Why: a rank's gradient block is its own work's part of
    the whole.  Along an axis the spec names, the work of the other ranks
    touches other blocks, except where the layer gathered the leaf over
    that axis, and then the gather's backward (a sum-scatter) has summed
    their parts into this block already.  Along an axis the spec does not
    name, the ranks hold the same block and did different work (other
    batch rows, other positions of the sequence, other query heads,
    vocabulary columns, channels or experts: every such split reads the
    leaf whole or cuts its own part out of it, whose gradient is zero
    elsewhere), so their parts are summed.  Where the batch axes split no
    rows their ranks did the same work, so the sum over them (in either
    way) counted it once per rank, and the scale takes that back."""
    mesh = place.mesh
    batch = set(T._batch_axes(rules))
    dup = math.prod(mesh.shape[a] for a in mesh.axis_names
                    if a in ("pod", "data") and a not in batch)
    out = []
    for i in range(len(place.specs)):
        named = set(place.axes(i))
        axes = tuple(a for a in mesh.axis_names if a not in named)
        out.append((axes, 1.0 / dup))
    return out


def _placement(cfg, mesh) -> Placement:
    """The placement of the parameter leaves on ``mesh``: every leaf by
    ``param_specs``, each split dim checked to split into equal blocks
    (the optimizer's means assume it)."""
    specs = T.param_specs(cfg)
    place = Placement(mesh, tuple(tree_leaves(specs, is_leaf=is_spec)))
    for i, leaf in enumerate(tree_leaves(T.param_shapes(cfg))):
        for dim, size in enumerate(leaf.shape):
            if size % place.ranks(i, dim):
                raise ValueError(
                    f"leaf {i}'s dim {dim} of {size} does not split evenly "
                    f"over {place.axes(i, dim)}")
    return place


def _reduce_grads(mesh, grad_axes, grads) -> None:
    """Each gradient leaf summed in place over its axes and scaled."""
    for g, (axes, scale) in zip(grads, grad_axes):
        if axes:
            mesh.all_reduce(g, axes, part="grad")
        if scale != 1.0:
            g.mul_(scale)


def _compress_grads(grads, err):
    """bf16 stochastic-free compression with error feedback: each gradient
    plus its carried error, rounded to bf16 and back; the rounding error is
    carried to the next step.  Returns (the restored float32 grads, the
    new errors)."""
    def comp(g, e):
        g32 = g.to(torch.float32) + e
        q = g32.to(torch.bfloat16).to(torch.float32)
        return q, g32 - q
    out = tree_map(comp, grads, err)
    leaves = tree_leaves(out)           # (q, e) tuples flatten to pairs
    return (tree_unflatten(grads, leaves[0::2]),
            tree_unflatten(grads, leaves[1::2]))


def _split(x, microbatches: int, i: int):
    """Microbatch ``i`` of this rank's rows.  Over a mesh the reference
    cuts the global batch instead, each microbatch then split over the
    batch axes, so a rank's rows of a microbatch differ; but either way
    every (microbatch, batch shard) pair holds one of the same runs of
    ``B / (microbatches * shards)`` consecutive rows, and the loss and
    gradients are means over those runs, so they are the reference's."""
    b = x.shape[0] // microbatches
    return x[i * b:(i + 1) * b]


def make_grad_fn(cfg: T.ModelConfig, *, rules=NO_SHARD, mesh=None,
                 microbatches: int = 1):
    """Returns ``grads_of(params, batch) -> (loss, grads)``: the
    reference's ``value_and_grad`` of its loss (the mean over
    ``microbatches``, as its scan accumulates them).  Over a mesh each
    rank's gradient leaf is finished by ``_reduce_grads``: it is the
    reference's leaf cut to this rank's block."""
    place = _placement(cfg, mesh) if mesh is not None else None
    return _grad_fn(cfg, rules, mesh, place, microbatches)


def _grad_fn(cfg, rules, mesh, place: Placement | None, microbatches: int):
    if mesh is not None and (rules.act_seq is None or
                             rules.act_seq != rules.tensor):
        raise ValueError("training over a mesh takes the train rules, "
                         "sequence-parallel over the tensor axis "
                         "(make_rules(kind='train'))")
    loss_fn = make_loss_fn(cfg, rules=rules, mesh=mesh)
    grad_axes = (_grad_axes(cfg, rules, place) if mesh is not None
                 else None)

    def value_and_grad(params, leaves, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, grads = value_and_grad(params, leaves, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            for i in range(microbatches):
                mb = {k: _split(v, microbatches, i)
                      for k, v in batch.items()}
                l, g = value_and_grad(params, leaves, mb)
                for a, b in zip(acc, g):
                    a += b.to(torch.float32)
                loss = loss + l
            inv = 1.0 / microbatches
            loss, grads = loss * inv, [a * inv for a in acc]
        if mesh is not None:
            _reduce_grads(mesh, grad_axes, grads)
        return loss, tree_unflatten(params, grads)

    return grads_of


def make_train_step(cfg: T.ModelConfig, optimizer: Optimizer, *,
                    rules=NO_SHARD, mesh=None, microbatches: int = 1,
                    grad_compression: bool = False):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss"})``; ``batch["tokens"]: [B, S]`` (and
    ``batch["cross_src"]`` for a model with cross layers).  The parameters
    and the optimizer state are updated in place and returned.

    Over a mesh, ``batch`` holds this rank's rows (``batch_specs``), the
    parameters and the optimizer state this rank's blocks by
    ``param_specs`` (and ``optimizer.init_specs``); the loss is the
    global one on every rank."""
    placement = _placement(cfg, mesh) if mesh is not None else None
    grads_of = _grad_fn(cfg, rules, mesh, placement, microbatches)

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        if grad_compression:
            grads, err = _compress_grads(grads, opt_state["grad_err"])
            inner = optimizer.apply(grads, opt_state["inner"], params, step,
                                    placement=placement)
            opt_state = {"inner": inner, "grad_err": err}
        else:
            opt_state = optimizer.apply(grads, opt_state, params, step,
                                        placement=placement)
        return params, opt_state, {"loss": loss}

    return train_step


def init_opt_state(cfg: T.ModelConfig, optimizer: Optimizer, params,
                   grad_compression: bool = False):
    inner = optimizer.init(params)
    if not grad_compression:
        return inner
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    return {"inner": inner, "grad_err": err}
