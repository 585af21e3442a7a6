"""Train-step builder: loss -> grad -> (optional compression) -> optimizer
(port of ``repro/train/train_step.py``).

Microbatch gradient accumulation (a Python loop where the reference
scans) and optional bf16 gradient compression with error feedback.  The
gradients come from ``torch.autograd.grad`` over the parameter tree's
leaves (set to require grad); the optimizer then adds its updates to the
parameters in place, under ``torch.no_grad``, one stack slice at a time
(``Optimizer.apply``), and writes its state in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.train.optimizer import Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_loss_fn(cfg: T.ModelConfig):
    def loss_fn(params, batch):
        return T.lm_loss(cfg, params, batch["tokens"],
                         cross_src=batch.get("cross_src"))
    return loss_fn


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


def make_train_step(cfg: T.ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1, grad_compression: bool = False):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss"})``; ``batch["tokens"]: [B, S]`` (and
    ``batch["cross_src"]`` for a model with cross layers).  The parameters
    and the optimizer state are updated in place and returned."""
    loss_fn = make_loss_fn(cfg)

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
            return loss, tree_unflatten(params, grads)

        def split(x, i):
            b = x.shape[0] // microbatches
            return x[i * b:(i + 1) * b]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(microbatches):
            mb = {k: split(v, i) for k, v in batch.items()}
            l, g = value_and_grad(params, leaves, mb)
            for a, b in zip(acc, g):
                a += b.to(torch.float32)
            loss = loss + l
        inv = 1.0 / microbatches
        return loss * inv, tree_unflatten(params, [a * inv for a in acc])

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        if grad_compression:
            grads, err = _compress_grads(grads, opt_state["grad_err"])
            inner = optimizer.apply(grads, opt_state["inner"], params, step)
            opt_state = {"inner": inner, "grad_err": err}
        else:
            opt_state = optimizer.apply(grads, opt_state, params, step)
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
