#!/usr/bin/env python3
"""The readings that the limits of the comparison that decides
``correct`` are set from: the program's, the control's and the planted
faults'.  The control is the plain reference put in the program's place,
computed in the precision below the configurations' (float32 with TF32
on, for float32 with TF32 off); it has to come out as not correct, and
so has each fault (``navisbench/faults.py``).

    python3 navisbench/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds 10 [--faults lanes_swapped one_hop ...] \\
        [--fault-seconds 5] [--corpus-seeds 7 8 ...]

For each seed (and each ``--corpus-seeds`` data set, by default the
configuration's), in one process: the cell's set-up and a window of the
program at the cell's own size and load, its answers judged (the
program's readings, with its queries a second, tail and hops), then a
window under each fault in turn, then the first window's queries
answered by the reference in TF32 and judged the same way.  Prints one
JSON line a seed.  Needs a CUDA device: TF32 exists only there.  The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "navisbench":
    del sys.path[0]


def _window(cell, loop, data, workload, limits, k) -> tuple:
    """One window of the program on the cell's state: (Outputs, numbers,
    correct, recall, rates)."""
    import numpy as np

    from navisbench import compare, harness
    rec = harness.Record(cell=workload)
    out = loop.window(cell, data, rec)
    numbers, ok, recall = compare.judge(out, limits, k)
    n = sum(op["n"] for op in rec.ops_of("search"))
    rates = {"search_qps": rec.n_answered / rec.window_s,
             "search_p95_ms": float(np.percentile(rec.latencies_s, 95)) * 1e3,
             "hops_per_query": rec.counters["search"]["hops"] / n,
             "waves": len(rec.ops_of("search"))}
    return out, numbers, ok, recall, rates


def readings(root: Path, workload: str, seed: int, seconds: float,
             device="cuda", faults=(), fault_seconds: float = 5.0,
             corpus_seed=None) -> dict:
    """The program's, the control's and each fault's numbers for one
    seed (``corpus_seed``: another data set than the configuration's)."""
    import torch

    from navisbench import cell as cell_mod
    from navisbench import compare, harness, tracing
    from navisbench import faults as faults_mod
    from navisbench.reference import exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark(root)
    entry = harness.workload(bench, workload)
    cfg = harness.load_config(root, bench, entry["config"])
    if corpus_seed is not None:
        cfg = dict(cfg, corpus=dict(cfg["corpus"], seed=corpus_seed))
    mix = harness.load_traffic(root, entry["traffic"])
    limits = harness.load_limits(root, workload)
    loop = harness.load_loop(root, mix["loop"])
    dev = torch.device(device)
    cell = cell_mod.build(cfg, mix, seed, seconds, dev,
                          tracing.Tracer(False, dev, seconds, 0, 0))
    data = loop.setup(cell)
    k = cfg["k"]

    def numbers_of(numbers, ok, recall, **more):
        return {"correct": ok, "recall_at_10": recall,
                **{n: v["value"] for n, v in numbers.items()}, **more}

    result = {"workload": workload, "seed": seed,
              "corpus_seed": cfg["corpus"]["seed"], "build_s": cell.build_s}
    out, numbers, ok, recall, rates = _window(cell, loop, data, workload,
                                              limits, k)
    result["program"] = numbers_of(numbers, ok, recall, **rates)
    cell.seconds = fault_seconds
    for name in faults:
        with faults_mod.planted(name):
            _, f_numbers, f_ok, f_recall, _ = _window(
                cell, loop, data, workload, limits, k)
        result[name] = numbers_of(f_numbers, f_ok, f_recall)
    cell.engine = cell.state = data = None
    gc.collect()
    torch.cuda.empty_cache()
    ids, d = exact.topk(out.pool[out.query_rows], out.base, k,
                        dtype=torch.float32, tf32=True)
    ctl = dataclasses.replace(out, ids=ids, dists=d.to(torch.float32))
    c_numbers, c_ok, c_recall = compare.judge(ctl, limits, k)
    result["control"] = numbers_of(c_numbers, c_ok, c_recall)
    result["answers"] = int(ids.shape[0])
    return result


def main() -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seconds", type=float, default=5.0)
    p.add_argument("--corpus-seeds", type=int, nargs="*", default=[None])
    args = p.parse_args()
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for corpus_seed in args.corpus_seeds:
        for seed in args.seeds:
            print(json.dumps(readings(
                ROOT, args.workload, seed, args.seconds,
                faults=args.faults, fault_seconds=args.fault_seconds,
                corpus_seed=corpus_seed)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
