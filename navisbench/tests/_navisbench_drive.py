"""Run tiny cells of the benchmark on the CPU, one after another in this
process, through ``navisbench.run.main``'s test route, optionally with
the timed path broken underneath (``navisbench/faults.py``).  Prints one JSON line a
scenario.  Used by the CPU tests; not a benchmark entry point."""
from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

import torch  # noqa: E402

from navisbench import faults, run  # noqa: E402


def scenario(root: str, spec: str) -> dict:
    cell, trace, *fault = spec.split(":")
    out, err = io.StringIO(), io.StringIO()
    with faults.planted(*fault), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "3000000019",
                       "--seconds", "0.5", "--trace", trace],
                      root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return {"scenario": spec, "rc": rc, "result": result,
            "stderr": err.getvalue()[-2000:]}


if __name__ == "__main__":
    torch.set_num_threads(1)
    for spec in sys.argv[2:]:
        print(json.dumps(scenario(sys.argv[1], spec)), flush=True)
