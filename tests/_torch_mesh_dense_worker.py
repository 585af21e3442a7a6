"""One rank of the port's dense placement over a gloo mesh, for
``test_torch_mesh_dense.py``: it imports only torch and the port.

The parent pickles the job (numpy only): the mesh's shape and axes and,
for each twin, its weights, prompts, teacher-forced tokens, the cross
source where the model has one, and a training batch.  Every leaf is
placed by ``param_specs`` (``shard_tree``).  For each twin the rank serves
(prefill, then teacher-forced decode steps) with the rules' sequence
parallel attention and with it flipped, and over one row (decode's
sequence over every axis), and where the twin has them (gemma3) over
prompts that outrun its window, both ways of rows; takes the loss and
its gradient blocks, both
ways again; runs two train steps; counts its parameter and optimizer
state bytes; counts the collectives of a prefill, a decode step and a
train step (calls and bytes in all, by part and by kind); and, for the
twin given ``uneven_frames``, takes the loss and gradients with a cross
source of that many frames, which need not split over the tensor axis.
It writes its results next to the job.
"""
import dataclasses
import pickle

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch import interop
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import P
from repro_torch.train import optimizer as O
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (init_opt_state, make_grad_fn,
                                          make_train_step)
from repro_torch.tree import tree_leaves


def _np(tree) -> list:
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


LR = 1e-3


def optimizer(arch_id):
    """The twin's optimizer as the tests run it (AdamW's moments in
    float32, so they compare as the parameters do)."""
    name = C.get_arch(arch_id).optimizer
    kw = {"state_dtype": "float32"} if name == "adamw" else {}
    return O.make_optimizer(name, lr=LR, **kw)


def _flip(rules):
    return dataclasses.replace(rules,
                               seq_parallel_attn=not rules.seq_parallel_attn)


def _rows(mesh, rules, data: dict) -> dict:
    tensors = {k: torch.from_numpy(v) for k, v in data.items()}
    return M.shard_tree(tensors, M.batch_specs(mesh, rules, tensors), mesh)


def _serve(mesh, cfg, params, t, rows: int, flip: bool,
           pre: str = "") -> dict:
    """Prefill over the twin's first ``rows`` prompts (``pre`` names
    another set), then its teacher-forced decode steps: this rank's logits
    at each step and its final caches."""
    tokens, nxt = t[pre + "tokens"][:rows], t[pre + "next"][:rows]
    B, S = tokens.shape
    steps = nxt.shape[1]
    rp = M.make_rules(mesh, kind="prefill", global_batch=B, cfg=cfg)
    rd = M.make_rules(mesh, kind="decode", global_batch=B, cfg=cfg)
    if flip:
        rp = _flip(rp)
    data = {"tokens": tokens, "next": nxt}
    if "cross" in t:
        data["cross"] = t["cross"][:rows]
    data = _rows(mesh, rp, data)
    prefill = make_prefill_step(cfg, rules=rp, mesh=mesh, max_seq=S + steps)
    decode = make_decode_step(cfg, rules=rd, mesh=mesh)
    logits, cache = prefill(params, data["tokens"], data.get("cross"))
    out = {"prefill": logits.numpy().copy(), "decode": []}
    for i in range(steps):
        _, logits, cache = decode(params, cache, data["next"][:, i:i + 1],
                                  S + i)
        out["decode"].append(logits.numpy().copy())
    out["cache"] = interop.to_numpy(cache)
    return out


def _train_rules(mesh, cfg, B: int, flip: bool = False):
    rules = M.make_rules(mesh, kind="train", global_batch=B, cfg=cfg)
    return _flip(rules) if flip else rules


def _batch(mesh, rules, t) -> dict:
    data = {"tokens": t["train_tokens"]}
    if "train_cross" in t:
        data["cross_src"] = t["train_cross"]
    return _rows(mesh, rules, data)


def _grads(mesh, cfg, t, flip: bool) -> dict:
    rules = _train_rules(mesh, cfg, t["train_tokens"].shape[0], flip)
    params = M.shard_tree(interop.params_from(t["params"], "cpu"),
                          T.param_specs(cfg), mesh)
    mesh.reset_stats()
    loss, grads = make_grad_fn(cfg, rules=rules, mesh=mesh)(
        params, _batch(mesh, rules, t))
    return {"loss": float(loss), "grads": _np(grads),
            "stats": dict(mesh.stats)}


def _steps(mesh, arch_id, cfg, t) -> dict:
    rules = _train_rules(mesh, cfg, t["train_tokens"].shape[0])
    params = M.shard_tree(interop.params_from(t["params"], "cpu"),
                          T.param_specs(cfg), mesh)
    opt = optimizer(arch_id)
    state = init_opt_state(cfg, opt, params)
    step = make_train_step(cfg, opt, rules=rules, mesh=mesh)
    batch = _batch(mesh, rules, t)
    losses = []
    for i in range(2):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _np(params), "state": _np(state)}


def _counts(mesh) -> dict:
    return dict(mesh.stats, parts={k: dict(v) for k, v in mesh.parts.items()},
                kinds={k: dict(v) for k, v in mesh.kinds.items()})


def _step_counts(mesh, arch_id, cfg, params, t) -> dict:
    """The collectives this rank counts for one prefill (of the twin's
    four prompts), one decode step after it and one train step."""
    tokens, nxt = t["tokens"], t["next"]
    B, S = tokens.shape
    rp = M.make_rules(mesh, kind="prefill", global_batch=B, cfg=cfg)
    rd = M.make_rules(mesh, kind="decode", global_batch=B, cfg=cfg)
    data = {"tokens": tokens, "next": nxt}
    if "cross" in t:
        data["cross"] = t["cross"]
    data = _rows(mesh, rp, data)
    out = {}
    mesh.reset_stats()
    _, cache = make_prefill_step(cfg, rules=rp, mesh=mesh,
                                 max_seq=S + nxt.shape[1])(
        params, data["tokens"], data.get("cross"))
    out["prefill"] = _counts(mesh)
    mesh.reset_stats()
    make_decode_step(cfg, rules=rd, mesh=mesh)(params, cache,
                                               data["next"][:, :1], S)
    out["decode"] = _counts(mesh)
    rules = _train_rules(mesh, cfg, t["train_tokens"].shape[0])
    held = M.shard_tree(interop.params_from(t["params"], "cpu"),
                        T.param_specs(cfg), mesh)
    opt = optimizer(arch_id)
    step = make_train_step(cfg, opt, rules=rules, mesh=mesh)
    state = init_opt_state(cfg, opt, held)
    batch = _batch(mesh, rules, t)
    mesh.reset_stats()
    step(held, state, batch, 0)
    out["train"] = _counts(mesh)
    return out


def _uneven(mesh, cfg, t, frames: int) -> dict:
    """The loss and this rank's gradient blocks with the cross source cut
    to ``frames`` frames, which need not split over the tensor axis: the
    encoder's residual in ceiling blocks."""
    rules = _train_rules(mesh, cfg, t["train_tokens"].shape[0])
    params = M.shard_tree(interop.params_from(t["params"], "cpu"),
                          T.param_specs(cfg), mesh)
    batch = _rows(mesh, rules, {"tokens": t["train_tokens"],
                                "cross_src": t["train_cross"][:, :frames]})
    loss, grads = make_grad_fn(cfg, rules=rules, mesh=mesh)(params, batch)
    return {"loss": float(loss), "grads": _np(grads)}


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _memory(mesh, arch_id, cfg, params) -> dict:
    """This rank's parameter bytes and optimizer state bytes (AdamW with
    the architecture's moment dtype, and Adafactor), each beside the
    dry-run's model of them on this mesh."""
    arch = C.get_arch(arch_id)
    out = {"params": _bytes(params),
           "model": D.analytical_memory(arch_id, "train_4k", mesh,
                                        smoke=True),
           "optimizer": arch.optimizer, "opt": {}}
    shapes, specs = T.param_shapes(cfg), T.param_specs(cfg)
    for name in ("adamw", "adafactor"):
        opt = O.make_optimizer(name, state_dtype=arch.opt_state_dtype)
        out["opt"][name] = (
            _bytes(opt.init(params)),
            D._sharded_bytes(opt.init(shapes),
                             opt.init_specs(specs, shapes), mesh))
    return out


def _twin(mesh, arch_id, t) -> dict:
    cfg = C.get_arch(arch_id).smoke
    params = M.shard_tree(interop.params_from(t["params"], "cpu"),
                          T.param_specs(cfg), mesh)
    out = {"serve": _serve(mesh, cfg, params, t, 4, False),
           "serve_flip": _serve(mesh, cfg, params, t, 4, True),
           "serve_one": _serve(mesh, cfg, params, t, 1, False),
           "grads": _grads(mesh, cfg, t, False),
           "grads_flip": _grads(mesh, cfg, t, True),
           "steps": _steps(mesh, arch_id, cfg, t),
           "memory": _memory(mesh, arch_id, cfg, params),
           "sp_attn": M.make_rules(mesh, kind="prefill", global_batch=4,
                                   cfg=cfg).seq_parallel_attn,
           "counts": _step_counts(mesh, arch_id, cfg, params, t)}
    if "uneven_frames" in t:
        out["uneven"] = _uneven(mesh, cfg, t, t["uneven_frames"])
    if "wrap_tokens" in t:
        out["serve_wrap"] = _serve(mesh, cfg, params, t, 4, False, "wrap_")
        out["serve_wrap_one"] = _serve(mesh, cfg, params, t, 1, False,
                                       "wrap_")
    return out


def _padded(mesh) -> dict:
    """``gather_leaf`` of ``shard_tree``'s ceiling blocks of a [5, 7]
    leaf (5 rows over every rank: blocks 2, 2, 1 and an empty one)."""
    x = torch.arange(35, dtype=torch.float32).reshape(5, 7)
    on = L.OnMesh(mesh, M.make_rules(mesh, kind="train", global_batch=4))
    specs = {"a": P(mesh.axis_names, None), "b": P("data", "model")}
    held = M.shard_tree({"a": x, "b": x}, specs, mesh)
    return {k: L.gather_leaf(on, held[k], specs[k], {0: 5, 1: 7}).numpy()
            for k in specs}


def run(rank: int, world: int, store: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        with open(job, "rb") as f:
            w = pickle.load(f)
        mesh = M.make_mesh(w["shape"], w["axes"])
        res = {"coords": mesh.coords, "padded": _padded(mesh),
               "twins": {a: _twin(mesh, a, t) for a, t in w["twins"].items()}}
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
