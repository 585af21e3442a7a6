"""The dry-run's closed-form memory model over the production meshes (port
of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--out DIR]

For every (arch x shape) cell on the 16 x 16 mesh (``--multi-pod``: 2 x
16 x 16; ``--both-meshes``: each) it writes ``<arch>__<shape>__<mesh>.json``
with ``arch``, ``shape``, ``mesh``, ``devices`` and ``memory_model``,
the per-device bytes of the parameters, the optimizer state, gradients
and residual stack (train) or the KV / SSM caches (decode), and their
``total``.  Everything runs on the meta device over virtual meshes
(``launch.mesh.make_production_mesh``): no memory, no card, no process
group.  ``--smoke`` models the reduced configurations (the reference's
writes no memory model for them).

Left out: the fields that come from XLA's lowering, compiling and HLO
(``lower_s``, ``compile_s``, ``flops``, ``bytes_accessed``, ``memory``,
``collectives``, ``--dump-hlo``, and ``hlo_analysis.py``); eager PyTorch
has no compiled step to read them from.  Their counterpart, a
compiled-step analysis, is ROADMAP.md queue 1 item 5.8.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

from repro_torch import configs as C
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import is_spec
from repro_torch.train import optimizer as O
from repro_torch.tree import tree_leaves


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
             smoke: bool = False) -> dict:
    """One cell's record: the cell, the mesh and its memory model."""
    return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
            "devices": mesh.size,
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
    for mesh_name, mesh in meshes:
        for arch_id, shape_name in todo:
            tag = f"{arch_id}__{shape_name}__{mesh_name}"
            out_file = out_dir / f"{tag}.json"
            if args.skip_existing and out_file.exists():
                print(f"SKIP {tag} (exists)", flush=True)
                continue
            try:
                res = run_cell(arch_id, shape_name, mesh, mesh_name,
                               smoke=args.smoke)
            except Exception as e:  # noqa: BLE001 — the sweep keeps going
                failures += 1
                out_file.with_suffix(".err").write_text(
                    "".join(traceback.format_exception(e)))
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                continue
            out_file.write_text(json.dumps(res, indent=1))
            print(f"OK   {tag}: mem/dev~"
                  f"{res['memory_model']['total'] / 1e9:.2f}GB", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
