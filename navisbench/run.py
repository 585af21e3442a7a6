#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, on the CUDA
device of this machine, and print its result as the last line of
standard output.

    python3 navisbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the mix names its
driver loop.  Set-up draws the corpus and every input from ``--seed``,
builds the engine and warms up; the window then drives
``Engine.search_many`` for ``--seconds``.  After it, the program's state
is freed and the plain reference judges every answer and the sampled
replays of the page cache (``navisbench/compare.py``).  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, with a
profiled part of the window.

Without a CUDA device, or with fewer than the cell asks for, it exits
with code 3 and prints no result: it never falls back to the CPU.
"""
import time

T_PROCESS = time.perf_counter()       # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this folder heads the path; its modules are imported as
# ``navisbench.*`` only
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "navisbench":
    del sys.path[0]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402


def _arguments(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _on_path(root: Path) -> None:
    for p in (root / "src", root):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None, *, root=None, device=None, t_start=None) -> int:
    """Run a cell; return the exit code.  ``device`` (tests only) skips the
    look for a card and runs there, through the kernels' plain versions
    on the CPU."""
    t_start = T_PROCESS if t_start is None else t_start
    args = _arguments(argv)
    root = Path(root or ROOT)
    _on_path(ROOT)
    # every cache of the run at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(root / "build" / sub))
    import torch

    from navisbench import cell as cell_mod
    from navisbench import compare, harness, tracing

    trace = args.trace == 1
    try:
        bench = harness.load_benchmark(root)
        entry = harness.workload(bench, args.workload)
        cfg = harness.load_config(root, bench, entry["config"])
        mix = harness.load_traffic(root, entry["traffic"])
        limits = harness.load_limits(root, args.workload)
        loop = harness.load_loop(root, mix["loop"])
        wanted = harness.metrics_of(
            bench, args.workload, "per_layer" if trace else "end_to_end")
        readers = {m["name"]: harness.load_metric(root, m["name"])
                   for m in wanted}
    except harness.BenchmarkError as exc:
        print(f"navisbench: {exc}", file=sys.stderr)
        return 2
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < entry["chips"]:
            print(f"navisbench: {args.workload} needs {entry['chips']} CUDA "
                  f"device(s), this machine has {have}", file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    # one host thread for the program's CPU operators: the host paces
    # both cells, and a pool of threads spinning beside it spreads runs
    torch.set_num_threads(1)
    # the configurations' precision: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    tracer = tracing.Tracer(trace, dev, args.seconds, mix["trace_from"],
                            mix["trace_steps"])
    cell = cell_mod.build(cfg, mix, args.seed, args.seconds, dev, tracer)
    rec = harness.Record(cell=args.workload, build_s=cell.build_s)
    data = loop.setup(cell)
    rec.setup_s = time.perf_counter() - t_start
    out = loop.window(cell, data, rec)
    rec.trace, rec.trace_t0 = tracer.summary, tracer.started_at
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    # the program's state goes before the reference runs
    cell.engine = cell.state = data = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, correct, rec.recall = compare.judge(out, limits, cfg["k"])

    found = harness.forbidden_modules()
    if found:
        print(f"navisbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 4
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": numbers["bad_answers"]["value"],
              "metrics": metrics, "device": info}
    if trace and rec.trace:
        info["busy_s"] = rec.trace["busy_s"]
        info["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {k: rec.trace[k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = numbers
    for name, v in numbers.items():
        print(f"navisbench check {name}: {v['value']!r} (limit "
              f"{v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
