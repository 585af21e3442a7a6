"""Run the env phase and the mesh path of ``chip_smoke.py`` alone, on one
NVIDIA GPU: moonshot-v1-16b-a3b whole served through a 1 x 1 mesh on a
one-rank NCCL group against the same serve with no mesh, the dry-run
(each cell's step analysis and memory model) over every cell on both
production meshes, moonshot-v1-16b-a3b cut to 8 layers trained through
the mesh against no mesh, and the dense placement (``mesh:dense``:
qwen2-0.5b and hymba-1.5b served whole, qwen2-0.5b trained, every leaf
held as its block and gathered on use), each step's collectives against
the step analysis's counting mesh, with the paths' launch gates.

    python3 tools/mesh_phase.py

It prints the phases' JSON lines, then the path's launch counts.  Use it
to check a change to the mesh on the card quickly.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.kernels import ops
    try:
        smoke.phase_env(torch)
        mesh = smoke.mesh_path(torch, smoke.Paths(ops))
    except smoke.SmokeFailure as exc:
        print(f"mesh_phase: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"launches": mesh}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
