"""The dry-run over the production meshes: each cell's step analysis and
closed-form memory model (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--out DIR] [--dump-top]

For every (arch x shape) cell on the 16 x 16 mesh (``--multi-pod``: 2 x
16 x 16; ``--both-meshes``: each) it writes ``<arch>__<shape>__<mesh>.json``
with ``arch``, ``shape``, ``mesh``, ``devices``; ``flops`` (the step's dot
FLOPs), ``bytes_accessed`` (the memory traffic eager moves), ``collectives``
(bytes and calls by kind, calls and bytes by part), ``n_ops`` and
``max_trip`` from ``launch.step_analysis``, each per device per step, and
``analysis_s``; and ``memory_model``, the per-device bytes of the
parameters, the optimizer state, gradients and residual stack (train) or
the KV / SSM caches (decode), and their ``total``.  Everything runs on the
meta device over virtual meshes (``launch.mesh.make_production_mesh``,
counting): no memory, no card, no process group.  :func:`build_cell`
builds a cell's step (``make_train_step``, ``make_prefill_step`` or
``make_decode_step`` with the cell's rules and the counting mesh) and its
inputs as rank 0 holds them: its block of every parameter, optimizer and
cache leaf, its rows of the batch.  ``--dump-top`` writes each cell's
largest contributors to its traffic and collectives beside its JSON
(``<tag>.top.json``: the counterpart of ``--dump-hlo``).  ``--smoke`` runs
the reduced configurations (the reference's writes no memory model for
them).  The sweep prints its seconds.

Left out, with no eager counterpart (not zero-filled): ``lower_s`` and
``compile_s`` (nothing is lowered or compiled), XLA's ``memory``
(``memory_analysis``) and ``cost_analysis_keys``.  The reference's
``flops`` and ``bytes accessed`` come from XLA's cost analysis, which
counts a while body once; these come from the whole step, every loop
multiplied out.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch import configs as C
from repro_torch.launch import mesh as M
from repro_torch.launch import step_analysis as SA
from repro_torch.models import transformer as T
from repro_torch.models.layers import is_spec
from repro_torch.train import optimizer as O
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_leaves


def build_cell(arch_id: str, shape_name: str, mesh, *, smoke: bool = False):
    """``(step, args)`` of one cell on ``mesh`` (a counting mesh), ready
    for ``step_analysis.analyze(step, *args, mesh=mesh)``: the cell's step
    with its rules (the reference's ``build_cell``) and its inputs on the
    meta device as rank 0 holds them (``shard_tree`` by ``param_specs``,
    the optimizer's ``init`` of those blocks, ``cache_specs``, and the
    batch's rows by ``batch_specs``).  A decode step writes position
    ``seq_len - 1`` of its ``seq_len``-long caches."""
    arch = C.get_arch(arch_id)
    shape = C.SHAPES[shape_name]
    cfg = arch.smoke if smoke else arch.model
    rules = M.make_rules(mesh, kind=shape.kind,
                         global_batch=shape.global_batch, cfg=cfg)
    params = M.shard_tree(T.param_shapes(cfg), T.param_specs(cfg), mesh)
    specs = C.input_specs(arch, shape, smoke=smoke, rules=rules)
    if shape.kind == "decode":
        cache = M.shard_tree(specs["cache"], T.cache_specs(
            cfg, shape.global_batch, shape.seq_len, rules), mesh)
        tokens = M.shard_tree({"tokens": specs["tokens"]}, M.batch_specs(
            mesh, rules, {"tokens": specs["tokens"]}), mesh)["tokens"]
        step = make_decode_step(cfg, rules=rules, mesh=mesh)
        return step, (params, cache, tokens, shape.seq_len - 1)
    batch = M.shard_tree(specs, M.batch_specs(mesh, rules, specs), mesh)
    if shape.kind == "train":
        opt = O.make_optimizer(arch.optimizer,
                               state_dtype=arch.opt_state_dtype)
        step = make_train_step(cfg, opt, rules=rules, mesh=mesh)
        return step, (params, opt.init(params), batch, 0)
    step = make_prefill_step(cfg, rules=rules, mesh=mesh)
    return step, (params, batch["tokens"]) + (
        (batch["cross_src"],) if "cross_src" in batch else ())


def _sharded_bytes(shapes_tree, specs_tree, mesh) -> int:
    """Per-device bytes of a sharded tree: each leaf's dims divided by the
    product of their axes' sizes, rounded up, times its item size."""
    sizes = dict(mesh.shape)

    def leaf(sh, sp):
        n = 1
        for d, ax in zip(sh.shape, tuple(sp or ()) + (None,) * sh.dim()):
            axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
            k = 1
            for a in axes:
                k *= sizes.get(a, 1)
            n *= -(-d // k)
        return n * sh.dtype.itemsize

    shapes = tree_leaves(shapes_tree)
    specs = tree_leaves(specs_tree, is_leaf=is_spec)
    if len(shapes) != len(specs):
        raise ValueError(f"{len(shapes)} leaves against {len(specs)} specs")
    return sum(leaf(sh, sp) for sh, sp in zip(shapes, specs))


def analytical_memory(arch_id: str, shape_name: str, mesh, *,
                      smoke: bool = False) -> dict:
    """The closed-form per-device memory of one cell (the reference's
    model, integer for integer): sharded parameters; for train the
    optimizer state, gradients (as the parameters) and the residual
    stack saved between layers; for decode the caches."""
    arch = C.get_arch(arch_id)
    shape = C.SHAPES[shape_name]
    cfg = arch.smoke if smoke else arch.model
    rules = M.make_rules(mesh, kind=shape.kind,
                         global_batch=shape.global_batch)
    pshapes = T.param_shapes(cfg)
    pspecs = T.param_specs(cfg)
    out = {"params": _sharded_bytes(pshapes, pspecs, mesh)}
    if shape.kind == "train":
        opt = O.make_optimizer(arch.optimizer,
                               state_dtype=arch.opt_state_dtype)
        oshapes = opt.init(pshapes)
        ospecs = opt.init_specs(pspecs, pshapes)
        out["opt_state"] = _sharded_bytes(oshapes, ospecs, mesh)
        out["grads"] = out["params"]
        dsize = M.data_size(mesh)
        tp = mesh.shape.get("model", 1)
        b_loc = -(-shape.global_batch // dsize)
        out["residual_stack"] = (cfg.num_layers * b_loc *
                                 (shape.seq_len // tp) * cfg.d_model *
                                 cfg.dtype.itemsize)
    elif shape.kind == "decode":
        cshapes = T.cache_shapes(cfg, shape.global_batch, shape.seq_len,
                                 rules)
        cspecs = T.cache_specs(cfg, shape.global_batch, shape.seq_len, rules)
        out["kv_cache"] = _sharded_bytes(cshapes, cspecs, mesh)
    out["total"] = sum(out.values())
    return out


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str, *,
             smoke: bool = False, top_dir=None) -> dict:
    """One cell's record: the cell, the mesh, its step analysis (on
    ``mesh``'s counting twin) and its memory model.  ``top_dir``: write
    the step's largest contributors there too."""
    counting = M.Mesh(mesh.shape, virtual=True, counting=True)
    t0 = time.perf_counter()
    step, args = build_cell(arch_id, shape_name, counting, smoke=smoke)
    res = SA.analyze(step, *args, mesh=counting)
    analysis_s = time.perf_counter() - t0
    if top_dir is not None:
        top = {kind: SA.top_contributors(step, *args, mesh=counting,
                                         kind=kind)
               for kind in ("traffic", "collective")}
        tag = f"{arch_id}__{shape_name}__{mesh_name}"
        (Path(top_dir) / f"{tag}.top.json").write_text(
            json.dumps(top, indent=1))
    return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
            "devices": mesh.size, "flops": res["dot_flops"],
            "bytes_accessed": res["hbm_traffic_bytes"],
            "collectives": res["collectives"], "n_ops": res["n_ops"],
            "max_trip": res["max_trip"], "analysis_s": analysis_s,
            "memory_model": analytical_memory(arch_id, shape_name, mesh,
                                              smoke=smoke)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="model the reduced configurations")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose .json output already exists")
    ap.add_argument("--dump-top", action="store_true",
                    help="write each cell's largest contributors to its "
                         "traffic and collectives beside its JSON")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.both_meshes:
        meshes = [("pod16x16", M.make_production_mesh(multi_pod=False)),
                  ("pod2x16x16", M.make_production_mesh(multi_pod=True))]
    else:
        meshes = [("pod2x16x16" if args.multi_pod else "pod16x16",
                   M.make_production_mesh(multi_pod=args.multi_pod))]
    if args.all:
        todo = [(a, s) for a, s, _ in C.cells()]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all, are required")

    failures = 0
    start = time.perf_counter()
    for mesh_name, mesh in meshes:
        for arch_id, shape_name in todo:
            tag = f"{arch_id}__{shape_name}__{mesh_name}"
            out_file = out_dir / f"{tag}.json"
            if args.skip_existing and out_file.exists():
                print(f"SKIP {tag} (exists)", flush=True)
                continue
            try:
                res = run_cell(arch_id, shape_name, mesh, mesh_name,
                               smoke=args.smoke,
                               top_dir=out_dir if args.dump_top else None)
            except Exception as e:  # noqa: BLE001 — the sweep keeps going
                failures += 1
                out_file.with_suffix(".err").write_text(
                    "".join(traceback.format_exception(e)))
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                continue
            out_file.write_text(json.dumps(res, indent=1))
            print(f"OK   {tag}: analysis={res['analysis_s']:.2f}s "
                  f"flops={res['flops']:.3e} "
                  f"coll={res['collectives']['bytes_by_kind']['total']:.3e}B "
                  f"mem/dev~{res['memory_model']['total'] / 1e9:.2f}GB",
                  flush=True)
    print(f"sweep: {time.perf_counter() - start:.1f}s, {failures} failed",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
