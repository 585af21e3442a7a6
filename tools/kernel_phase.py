"""Run the env and kernel phases of ``chip_smoke.py`` alone, on one NVIDIA
GPU, for the checkout at ``--root`` (default: this repository).

    python3 tools/kernel_phase.py [--root DIR] [--timings]

It builds that checkout's CUDA kernels, holds each against its plain
version at the main path's shapes and times it, printing the phases' JSON
lines and then one line with every kernel's record.  Use it for a new
kernel's first call on the card (about 40 s of command time), and to
compare two commits in one call: unpack the other one with ``git archive``
into a directory that ``.gitignore`` lists, then run parent, change,
change, parent.  With ``--timings`` it runs only this repository's
``chip_smoke.kernel_timings`` (the merge's and CASR's device times by
case, and the launch floor) on the ``--root`` checkout's kernels, so both
sides of a comparison are timed on the same inputs and cases, new cases
included.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--timings", action="store_true",
                    help="only this repository's kernel_timings, on the "
                    "root's kernels")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(HERE if args.timings else root)]
    import torch
    if not torch.cuda.is_available():
        print("kernel_phase: no CUDA device", file=sys.stderr)
        return 2
    smoke = importlib.import_module("chip_smoke")
    try:
        smoke.phase_env(torch)
        if args.timings:
            print(json.dumps({"root": str(root),
                              **smoke.kernel_timings(torch)}))
            return 0
        records = smoke.phase_kernels(torch)
    except smoke.SmokeFailure as exc:
        print(f"kernel_phase: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"root": str(root), "kernels": list(records.values()),
                      **smoke.KERNEL_LINE}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
