"""Train-step builder: loss -> grad -> (optional compression) -> optimizer
(port of ``repro/train/train_step.py``).

Microbatch gradient accumulation (a Python loop where the reference
scans) and optional bf16 gradient compression with error feedback.  The
gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (set to require grad); the optimizer then adds its updates to the
parameters in place, under ``torch.no_grad``, one stack slice at a time
(``Optimizer.apply``), and writes its state in place.

Over a mesh (``rules`` / ``mesh``, the reference's arguments) each rank
holds its batch rows and its block of every parameter leaf by
``ep_specs(param_specs)`` (``layers.shard_tree``).  After
``autograd.grad`` each rank's gradient leaf is a partial that
``_reduce_grads`` finishes through the mesh, so that it equals the
reference's ``jax.grad`` leaf cut to the rank's block; the optimizer's
global reductions then go through the mesh too
(``optimizer.Placement``).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import NO_SHARD, ep_specs, is_spec
from repro_torch.train.optimizer import Optimizer, Placement
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

EXPERT_LEAVES = ("up", "gate", "down")


def make_loss_fn(cfg: T.ModelConfig, *, rules=NO_SHARD, mesh=None):
    def loss_fn(params, batch):
        return T.lm_loss(cfg, params, batch["tokens"],
                         cross_src=batch.get("cross_src"), rules=rules,
                         mesh=mesh)
    return loss_fn


def _grad_axes(cfg, rules, place: Placement) -> list[tuple[tuple, float]]:
    """For each parameter leaf (flattening order), the mesh axes its
    gradient is summed over and the factor it is scaled by.

    - A leaf held whole on every rank (``P()``) is a partial over the
      batch axes (each rank differentiates its own rows' loss; the MoE's
      ``mesh.enter`` made it whole over the tensor axis): summed over
      ``rules.batch``.
    - An expert leaf (``moe`` ``up`` / ``gate`` / ``down``): the gather's
      backward already summed its block over fsdp, so it is summed over
      the batch axes, the tensor and the fsdp axis that its spec does not
      name (``pod`` on pod x data x model; for a leaf that arrived whole
      along a dim, ``_local_experts`` cut it and its gradient is zero
      outside this rank's block, so the axis of that dim too).  Where
      fsdp splits no batch rows, its ranks held the same rows and the
      sum-scatter counted them each: scaled by 1 / its size.
    """
    mesh = place.mesh
    batch = set(T._batch_axes(rules))
    out = []
    for i, (path, _) in enumerate(tree_flatten_with_path(
            T.param_shapes(cfg))):
        if "moe" in path and path[-1] in EXPERT_LEAVES:
            named = set(place.axes(i))
            axes = (batch | {rules.tensor, rules.fsdp}) - named - {None}
            scale = (1.0 / mesh.shape[rules.fsdp]
                     if rules.fsdp is not None and rules.fsdp not in batch
                     else 1.0)
        else:
            axes, scale = batch, 1.0
        out.append((tuple(a for a in mesh.axis_names if a in axes), scale))
    return out


def _placement(cfg, mesh) -> Placement:
    """The placement of the parameter leaves on ``mesh``: the experts in
    blocks, every other leaf whole (``ep_specs``), each split dim checked
    to split into equal blocks (the optimizer's means assume it)."""
    specs = ep_specs(T.param_specs(cfg))
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
            mesh.all_reduce(g, axes)
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
    ``ep_specs(param_specs)``; the loss is the global one on every
    rank."""
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
