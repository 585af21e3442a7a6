"""Optimizers: AdamW (configurable state dtype) and factored Adafactor
(port of ``repro/train/optimizer.py``).

Plain functions on trees of tensors, with the reference's state structure
and arithmetic order: AdamW's state is ``{"m", "v", "count"}`` with ``m``
and ``v`` in ``state_dtype`` and the math in float32; Adafactor's is
``{"f": [per-leaf {"vr", "vc"} | {"v"}], "count"}``, a list in the
flattening order of :mod:`repro_torch.tree` (JAX's), so a state goes
across between the packages (``interop.opt_state_from``) and through
either checkpoint store.  ``init_specs(param_specs, param_shapes)``
mirrors a parameter spec tree (``layers.P`` leaves) onto the state, as
the reference's does for its dry-run (``launch/dryrun.py``).

``update(grads, state, params, step) -> (updates, state)`` is the
reference's call; ``apply(grads, state, params, step) -> state`` adds the
same updates to ``params`` in place.  Over a mesh both take a
:class:`Placement` as well (``placement=``), the one addition to the
reference's signature (see there).  Both compute one stack slice of a
leaf at a time (its index over all but the last two dims: a layer of a
``[repeats, count, ...]`` stack, an expert), so a stacked leaf's float32
temporaries are one slice's, never the whole stack's; the arithmetic is
elementwise (Adafactor's factors reduce over the last two dims only), so
the result is the whole-leaf result.  Both write the state's leaves in
place and return the state.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import torch

from repro_torch import trips
from repro_torch.models.layers import P, is_spec
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    apply: Callable[[Any, Any, Any, Any], Any]
    # init_specs(param_specs, param_shapes) -> the state's spec tree
    init_specs: Callable[[Any, Any], Any]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where each parameter leaf lies over a ``launch.mesh.Mesh``:
    ``specs`` holds each leaf's spec (``layers.P``) in flattening order,
    the leaf being this rank's block by ``shard_tree``.

    The reference's optimizer needs no such argument: under GSPMD its
    global norm, Adafactor's row and column means and its update RMS are
    global by construction.  Here each rank holds a block, so a sum over
    a dim split across ranks is finished by an ``all_reduce`` over the
    axes that split it (a replicated leaf counts once).  A mean over a
    split dim is the ranks' local means summed over the group, over the
    group's size, so the blocks must be equal (``make_train_step`` checks
    it); on a mesh of one rank the arithmetic is that of no mesh."""
    mesh: Any
    specs: tuple

    def axes(self, i: int, dim: int | None = None) -> tuple[str, ...]:
        """The mesh axes splitting leaf ``i`` (along ``dim`` only, a
        non-negative index, where given), in mesh order."""
        spec = tuple(self.specs[i] or ())
        entries = spec if dim is None else spec[dim:dim + 1]
        named = set()
        for ax in entries:
            named.update(ax if isinstance(ax, tuple) else
                         (ax,) if ax else ())
        return tuple(a for a in self.mesh.axis_names if a in named)

    def ranks(self, i: int, dim: int | None = None) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes(i, dim))

    def mean(self, x: torch.Tensor, i: int, dim: int) -> torch.Tensor:
        """``x``, a mean over this rank's part of leaf ``i``'s ``dim``,
        made the mean over the whole dim."""
        axes = self.axes(i, dim)
        if not axes:
            return x
        return (self.mesh.all_reduce(x, axes, part="opt") /
                self.ranks(i, dim))

    def sum_leaves(self, values: list) -> list:
        """Each leaf's scalar partial sum (in leaf order) summed over the
        axes splitting that leaf: one ``all_reduce`` per set of axes."""
        values = list(values)
        groups: dict[tuple, list[int]] = {}
        for i in range(len(values)):
            groups.setdefault(self.axes(i), []).append(i)
        for axes, idx in groups.items():
            if axes:
                summed = self.mesh.all_reduce(
                    torch.stack([values[i] for i in idx]), axes, part="opt")
                for i, v in zip(idx, summed.unbind(0)):
                    values[i] = v
        return values


def _mean(placement, x, i: int, dim: int) -> torch.Tensor:
    return x if placement is None else placement.mean(x, i, dim)


def _slices(shape):
    """The stack slices of a leaf: every index over all but its last two
    dims (one slice, the whole leaf, for a leaf of two dims or fewer),
    each with its count (``trips.each``: the slices do alike)."""
    return trips.each(itertools.product(*map(range, shape[:-2])))


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _constant(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def _update_and_apply(run: Callable) -> tuple[Callable, Callable]:
    """``update`` and ``apply`` from ``run(grads, state, params, step,
    sink, placement)``, which calls ``sink(i, idx, u)`` with the float32
    update of stack slice ``idx`` of leaf ``i``."""
    def update(grads, state, params, step, placement=None):
        out = [torch.empty(g.shape, dtype=torch.float32, device=g.device)
               for g in tree_leaves(grads)]

        def sink(i, idx, u):
            out[i][idx] = u
        state = run(grads, state, params, step, sink, placement)
        it = iter(out)
        return tree_map(lambda _: next(it), grads), state

    def apply(grads, state, params, step, placement=None):
        leaves = tree_leaves(params)

        def sink(i, idx, u):
            p = leaves[i][idx]
            p += u.to(p.dtype)
        with torch.no_grad():
            return run(grads, state, params, step, sink, placement)
    return update, apply


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree, placement: Placement | None = None
                ) -> torch.Tensor:
    """The L2 norm over every leaf; over a mesh (``placement``) over every
    leaf's whole, each leaf's sum of squares summed over its blocks."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if placement is not None:
        leaves = placement.sum_leaves(leaves)
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to 0 at ``total``; float32, as the reference computes it."""
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float | Callable = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          state_dtype: str = "bfloat16", max_grad_norm: float = 1.0
          ) -> Optimizer:
    dtype = getattr(torch, state_dtype)
    lr_fn = lr if callable(lr) else _constant(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}

    def run(grads, state, params, step, sink, placement):
        g_leaves = tree_leaves(grads)
        scale = (_clip_scale(global_norm(grads, placement), max_grad_norm)
                 if max_grad_norm else None)
        count = state["count"] + 1
        c = count.to(torch.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        neg_lr = -lr_fn(step)
        leaves = zip(g_leaves, tree_leaves(state["m"]),
                     tree_leaves(state["v"]), tree_leaves(params))
        for i, (g, m, v, p) in enumerate(leaves):
            for idx, _ in _slices(g.shape):
                gs = g[idx].detach()
                if scale is not None:
                    gs = gs * scale.to(gs.dtype)
                g32 = gs.to(torch.float32)
                m32 = b1 * m[idx].to(torch.float32) + (1 - b1) * g32
                v32 = b2 * v[idx].to(torch.float32) + \
                    (1 - b2) * torch.square(g32)
                mhat = m32 / bc1
                vhat = v32 / bc2
                u = neg_lr * (mhat / (torch.sqrt(vhat) + eps) +
                              weight_decay * p[idx].detach().to(torch.float32))
                m[idx] = m32
                v[idx] = v32
                sink(i, idx, u)
        return {"m": state["m"], "v": state["v"], "count": count}

    def init_specs(param_specs, param_shapes=None):
        return {"m": param_specs, "v": param_specs, "count": P()}

    return Optimizer(init, *_update_and_apply(run), init_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum) — for the ≥100B archs
# ---------------------------------------------------------------------------

def _factored(p_shape) -> bool:
    return len(p_shape) >= 2 and p_shape[-1] > 1 and p_shape[-2] > 1


def adafactor(lr: float | Callable = 1e-3, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer.  The factor state is a list
    aligned with the flattened parameter order.  The update's RMS clip
    spans the whole leaf, so each leaf takes passes over its slices: the
    factors' means (finished over the mesh, where a placement splits the
    leaf), the squared update's sum (finished over the mesh for every
    leaf at once), then the update recomputed and handed on scaled."""
    lr_fn = lr if callable(lr) else _constant(lr)
    f32 = torch.float32

    def _leaf_state(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=f32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=f32, device=p.device)}

    def init(params):
        leaves = tree_leaves(params)
        return {"f": [_leaf_state(p) for p in leaves],
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device)}

    def _denom(st, idx, vr_mean):
        if "vr" in st:
            vr, vc = st["vr"][idx], st["vc"][idx]
            return (vr[..., None] / vr_mean[idx][..., None]) * \
                vc[..., None, :]
        return st["v"][idx]

    def _factors(g, st, i, beta, placement):
        """The new row and column factors of leaf ``i`` (their means over
        the whole leaf's dims), and the mean of the new row factor."""
        row = torch.empty_like(st["vr"])
        col = torch.empty_like(st["vc"])
        for idx, _ in _slices(g.shape):
            g32 = g[idx].detach().to(f32)
            # two square+reduce expressions, as the reference's
            row[idx] = torch.mean(torch.square(g32), dim=-1)
            col[idx] = torch.mean(torch.square(g32), dim=-2)
        row = _mean(placement, row, i, g.dim() - 1) + eps
        col = _mean(placement, col, i, g.dim() - 2) + eps
        st["vr"].copy_(beta * st["vr"] + (1 - beta) * row)
        st["vc"].copy_(beta * st["vc"] + (1 - beta) * col)
        return _mean(placement, torch.mean(st["vr"], dim=-1, keepdim=True),
                     i, g.dim() - 2)

    def run(grads, state, params, step, sink, placement):
        count = state["count"] + 1
        c = count.to(f32)
        beta = 1.0 - c ** (-decay)
        neg_lr = -lr_fn(step)
        g_leaves = tree_leaves(grads)
        sq_sums = []
        vr_means = []
        for i, (g, st) in enumerate(zip(g_leaves, state["f"])):
            vr_mean = None
            if "vr" in st:
                vr_mean = _factors(g, st, i, beta, placement)
            sq_sum = torch.zeros((), dtype=f32, device=g.device)
            for idx, _ in _slices(g.shape):
                g32 = g[idx].detach().to(f32)
                if "v" in st:
                    st["v"][idx] = beta * st["v"][idx] + \
                        (1 - beta) * (torch.square(g32) + eps)
                u = g32 * torch.rsqrt(_denom(st, idx, vr_mean) + eps)
                sq_sum = sq_sum + torch.sum(torch.square(u))
            sq_sums.append(sq_sum)
            vr_means.append(vr_mean)
        if placement is not None:
            sq_sums = placement.sum_leaves(sq_sums)
        for i, (g, st) in enumerate(zip(g_leaves, state["f"])):
            # update clipping (RMS <= clip_threshold)
            n = g.numel() * (1 if placement is None else placement.ranks(i))
            rms = torch.sqrt(sq_sums[i] / n + 1e-30)
            div = torch.clamp(rms / clip_threshold, min=1.0)
            for idx, _ in _slices(g.shape):
                u = g[idx].detach().to(f32) * torch.rsqrt(
                    _denom(st, idx, vr_means[i]) + eps)
                sink(i, idx, neg_lr * (u / div))
        return {"f": state["f"], "count": count}

    def init_specs(param_specs, param_shapes):
        # a factor's spec is the parameter's with the reduced dim dropped
        out = []
        for spec, shp in zip(tree_leaves(param_specs, is_leaf=is_spec),
                             tree_leaves(param_shapes)):
            spec = tuple(spec or ())
            spec = spec + (None,) * (len(shp.shape) - len(spec))
            if _factored(shp.shape):
                out.append({"vr": P(*spec[:-1]),
                            "vc": P(*spec[:-2], spec[-1])})
            else:
                out.append({"v": P(*spec)})
        return {"f": out, "count": P()}

    return Optimizer(init, *_update_and_apply(run), init_specs)


def make_optimizer(name: str, *, state_dtype: str = "bfloat16",
                   lr=None) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr or 3e-4, state_dtype=state_dtype)
    if name == "adafactor":
        return adafactor(lr=lr or 1e-3)
    raise ValueError(f"unknown optimizer {name}")
