#!/usr/bin/env python3
"""The cache replay's soak test on one NVIDIA GPU: replay a benchmark
cell's search waves again and again, each from the cache it began with,
and count the launches that fail or that leave other tables.

    python3 tools/replay_soak.py [--cell fineweb768.query] [--waves 20] \\
        [--reps 50] [--seed S]

From the root of a checkout.  Builds the cell's index as the benchmark
does (``navisbench/cell.py``), runs ``--waves`` ``search_many`` waves of
the cell's wave size, chained as the closed loop chains them, and keeps
each wave's replay input (the cache before it and the wave's page
traces) on the host.  Then it replays every kept input ``--reps`` times
through ``kernels.ops.cache_replay``: the first replay of an input is
held against the host's (``kernels.ref.cache_apply``), and every later
one against the first.  The replay is one serial chain, so a launch that
fails or differs is a fault of the kernel, not of the input.  Prints one
JSON line; a failed launch loses the CUDA context, so it is printed with
the replays so far and the process exits with 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _collect(cell_name: str, seed: int, n_waves: int) -> list[dict]:
    """The replay inputs of ``n_waves`` chained waves (after a warm-up)."""
    import torch

    from navisbench import cell as cell_mod
    from navisbench import corpus, harness, tracing
    from repro_torch.core import cache as cache_mod
    bench = harness.load_benchmark(HERE)
    entry = harness.workload(bench, cell_name)
    cfg = harness.load_config(HERE, bench, entry["config"])
    mix = harness.load_traffic(HERE, entry["traffic"])
    dev = torch.device("cuda")
    cell = cell_mod.build(cfg, mix, seed, 0, dev,
                          tracing.Tracer(False, dev, 0, 0, 0))
    cap = mix["wave_cap"]
    pool = corpus.draw(cell.gen, cell.mixture, cap * (n_waves + 1))
    kept = []
    inner = cache_mod.apply_traces

    def apply_traces(st, traces):
        kept.append({"policy": st.policy, "traces": traces.cpu(),
                     "tables": [getattr(st, n).cpu()
                                for n in cache_mod.TABLES]})
        return inner(st, traces)

    cache_mod.apply_traces = apply_traces
    try:
        state = cell.state
        cell.engine.search_many(state, pool[:cap])       # the warm-up
        for i in range(1, n_waves + 1):
            _, _, _, state = cell.engine.search_many(
                state, pool[i * cap:(i + 1) * cap])
        torch.cuda.synchronize()
    finally:
        cache_mod.apply_traces = inner
    return kept[1:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="fineweb768.query")
    ap.add_argument("--waves", type=int, default=20)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=2718281901)
    args = ap.parse_args()
    for p in (HERE / "src", HERE):
        sys.path.insert(0, str(p))
    import torch

    from repro_torch.kernels import ops, ref
    if not torch.cuda.is_available():
        print("replay_soak: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    inputs = _collect(args.cell, args.seed, args.waves)
    first, mismatched, n = [], 0, 0
    for d in inputs:
        host = [t.clone() for t in d["tables"]]
        ref.cache_apply(d["policy"], host, traces=d["traces"])
        first.append([t.cuda() for t in host])
    status = {"device": torch.cuda.get_device_name(0), "cell": args.cell,
              "waves": len(inputs),
              "accesses_a_wave": sum(int((d["traces"] >= 0).sum())
                                     for d in inputs) / len(inputs)}
    for rep in range(args.reps):
        for k, d in enumerate(inputs):
            tables = [t.cuda() for t in d["tables"]]
            try:
                ops.cache_replay(d["policy"], tables, d["traces"].cuda())
                same = all(torch.equal(a, b)
                           for a, b in zip(tables, first[k]))
            except RuntimeError as exc:   # torch's AcceleratorError too
                print(json.dumps({**status, "replays": n, "failed": True,
                                  "input": k, "rep": rep,
                                  "error": str(exc).splitlines()[0]}))
                return 1
            mismatched += not same
            n += 1
    print(json.dumps({**status, "replays": n, "failed": False,
                      "mismatched": mismatched,
                      "seconds": time.perf_counter() - t0}))
    return 0 if mismatched == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
