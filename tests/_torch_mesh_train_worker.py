"""One rank of the port's training over a gloo mesh, for
``test_torch_mesh_train.py``: it imports only torch and the port.

The parent pickles the job (numpy only): the mesh's shape and axes, the
smoke twins' weights, tokens and capacity factor, and a checkpoint
written on one device.  For each twin the rank computes the loss and its
gradient blocks (``make_grad_fn``; for some twins also over one row,
which no batch axis splits), then two train steps from the same weights
(``make_train_step``; for some also one of microbatches), and restores
the checkpoint onto the mesh (``load(..., sharding=)``).  It writes its
results next to the job.
"""
import dataclasses
import pickle

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import configs as C
from repro_torch import interop
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import (init_opt_state, make_grad_fn,
                                          make_train_step)
from repro_torch.tree import tree_leaves


def _np(tree) -> list:
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def optimizer(arch_id):
    """The twin's optimizer as the tests run it (AdamW's moments in
    float32, so they compare as the parameters do)."""
    name = C.get_arch(arch_id).optimizer
    kw = {"state_dtype": "float32"} if name == "adamw" else {}
    return O.make_optimizer(name, lr=1e-3, **kw)


def _setup(mesh, arch_id, twin, global_batch):
    cfg = dataclasses.replace(C.get_arch(arch_id).smoke,
                              capacity_factor=twin["cf"])
    rules = M.make_rules(mesh, kind="train", global_batch=global_batch)
    tokens = torch.from_numpy(twin["tokens"])
    data = M.shard_tree({"tokens": tokens},
                        M.batch_specs(mesh, rules, {"tokens": tokens}),
                        mesh)
    return cfg, rules, data


def _params(mesh, cfg, twin):
    whole = interop.params_from(twin["params"], "cpu")
    return M.shard_tree(whole, T.param_specs(cfg), mesh)


def _grads(mesh, arch_id, twin, rows=None):
    """The loss and this rank's gradient blocks, over the twin's tokens
    (their first ``rows`` only: a global batch that fills no batch axis,
    so every rank holds every row)."""
    if rows is not None:
        twin = dict(twin, tokens=twin["tokens"][:rows])
    cfg, rules, data = _setup(mesh, arch_id, twin, twin["tokens"].shape[0])
    loss, grads = make_grad_fn(cfg, rules=rules, mesh=mesh)(
        _params(mesh, cfg, twin), data)
    return {"loss": float(loss), "grads": _np(grads)}


def _twin(mesh, arch_id, twin, microbatches, one_row):
    cfg, rules, data = _setup(mesh, arch_id, twin, twin["tokens"].shape[0])
    mesh.reset_stats()
    out = _grads(mesh, arch_id, twin)
    out["stats"] = dict(mesh.stats)
    if one_row:
        out["one_row"] = _grads(mesh, arch_id, twin, rows=1)
    opt = optimizer(arch_id)
    params = _params(mesh, cfg, twin)
    state = init_opt_state(cfg, opt, params)
    step = make_train_step(cfg, opt, rules=rules, mesh=mesh)
    out["losses"] = []
    for i in range(2):
        params, state, m = step(params, state, data, i)
        out["losses"].append(float(m["loss"]))
    out["params"], out["state"] = _np(params), _np(state)
    if microbatches:
        params = _params(mesh, cfg, twin)
        state = init_opt_state(cfg, opt, params)
        step = make_train_step(cfg, opt, rules=rules, mesh=mesh,
                               microbatches=microbatches)
        params, state, m = step(params, state, data, 0)
        out["micro"] = {"loss": float(m["loss"]), "params": _np(params),
                        "state": _np(state)}
    return out


def _restore(mesh, arch_id, twin, ckpt_dir):
    """The one-device checkpoint restored onto this mesh, against
    ``shard_tree`` of the whole tree: every leaf equal and a copy."""
    cfg = C.get_arch(arch_id).smoke
    opt = optimizer(arch_id)
    whole = interop.params_from(twin["params"], "cpu")
    like = {"params": whole, "opt": init_opt_state(cfg, opt, whole)}
    pspecs = T.param_specs(cfg)
    specs = {"params": pspecs,
             "opt": opt.init_specs(pspecs, T.param_shapes(cfg))}
    step, got = ckpt.load_latest(ckpt_dir, like, device="cpu",
                                 sharding=(specs, mesh))
    want = M.shard_tree(ckpt.load(ckpt_dir, step, like, device="cpu"),
                        specs, mesh)
    return [bool(torch.equal(g, w)) and g.untyped_storage().nbytes() ==
            g.numel() * g.element_size()
            for g, w in zip(tree_leaves(got), tree_leaves(want))]


def run(rank: int, world: int, store: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        with open(job, "rb") as f:
            w = pickle.load(f)
        mesh = M.make_mesh(w["shape"], w["axes"])
        res = {"coords": mesh.coords,
               "twins": {a: _twin(mesh, a, t, w["microbatches"].get(a),
                                  a in w["one_row"])
                         for a, t in w["twins"].items()},
               "restore": {a: _restore(mesh, a, t, w["ckpt"][a])
                           for a, t in w["twins"].items()}}
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
