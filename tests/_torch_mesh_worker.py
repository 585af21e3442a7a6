"""One rank of the port's mesh over a gloo group, for
``test_torch_mesh.py``: it imports only torch and the port.

The parent pickles the job (numpy only): the mesh's shape and axes, the
expert-parallel ``moe_block`` cases with their inputs, and, for the 2 x 2
mesh, the smoke twins' weights and tokens.  Each rank writes its rows of
every result next to it.
"""
import pickle

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch import interop
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import P
from repro_torch.train.serve_step import make_decode_step, make_prefill_step


def _moe_case(mesh, moe, case):
    """One ``moe_block`` case on this rank: x's rows by the batch axes,
    the expert leaves this rank's blocks (or whole, ``case["whole"]``)."""
    axes = M.batch_axes(mesh)
    batch = (axes if len(axes) > 1 else axes[0]) if case["batch"] else None
    rules = L.ShardingRules(batch=batch, tensor="model", fsdp="data",
                            moe_gather_weights=case["regime"] == "gather")
    x = torch.from_numpy(moe["x"])
    x = M.shard_tree({"x": x}, M.batch_specs(mesh, rules, {"x": x}),
                     mesh)["x"]
    names = ("router", "up", "down") + (("gate",) if case["glu"] else ())
    w = {k: torch.from_numpy(moe[k]) for k in names}
    if not case["whole"]:
        specs = {k: P("model", "data", None) if k != "router" else P()
                 for k in names}
        w = M.shard_tree(w, specs, mesh)
    return L.moe_block(w, x, n_experts=moe["E"], top_k=moe["K"],
                       capacity_factor=case["cf"], activation="silu",
                       glu=case["glu"], mesh=mesh, rules=rules).numpy()


def _twin(mesh, arch_id, twin):
    """The smoke twin over the mesh: prefill, then teacher-forced decode
    steps; this rank's logits at each step and its final caches."""
    cfg = C.get_arch(arch_id).smoke
    B, S = twin["tokens"].shape
    steps = twin["next"].shape[1]
    params = interop.params_from(twin["params"], "cpu")
    params = M.shard_tree(params, M.ep_specs(T.param_specs(cfg)), mesh)
    rp = M.make_rules(mesh, kind="prefill", global_batch=B, cfg=cfg)
    rd = M.make_rules(mesh, kind="decode", global_batch=B, cfg=cfg)
    data = {"tokens": torch.from_numpy(twin["tokens"]),
            "next": torch.from_numpy(twin["next"])}
    data = M.shard_tree(data, M.batch_specs(mesh, rp, data), mesh)
    prefill = make_prefill_step(cfg, rules=rp, mesh=mesh,
                                max_seq=S + steps)
    decode = make_decode_step(cfg, rules=rd, mesh=mesh)
    logits, cache = prefill(params, data["tokens"])
    out = {"prefill": logits.numpy().copy(), "decode": []}
    for i in range(steps):
        _, logits, cache = decode(params, cache, data["next"][:, i:i + 1],
                                  S + i)
        out["decode"].append(logits.numpy().copy())
    out["cache"] = interop.to_numpy(cache)
    return out


def _blocks(mesh):
    """``shard_tree``'s ceiling-division blocks of a [5, 7] leaf."""
    x = torch.arange(35, dtype=torch.float32).reshape(5, 7)
    specs = {"a": P(tuple(a for a in mesh.axis_names if mesh.shape[a] > 1),
                    None),
             "b": P("data", "model"), "c": P()}
    got = M.shard_tree({"a": x, "b": x, "c": x}, specs, mesh)
    return {k: v.numpy().copy() for k, v in got.items()}


def run(rank: int, world: int, store: str, job: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        with open(job, "rb") as f:
            w = pickle.load(f)
        mesh = M.make_mesh(w["shape"], w["axes"])
        res = {"coords": mesh.coords,
               "moe": {c["name"]: _moe_case(mesh, w["moe"], c)
                       for c in w["cases"]},
               "blocks": _blocks(mesh),
               "twins": {a: _twin(mesh, a, t)
                         for a, t in w.get("twins", {}).items()},
               "stats": dict(mesh.stats)}
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
