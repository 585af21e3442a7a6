"""Run the env phase and the mesh path of ``chip_smoke.py`` alone, on one
NVIDIA GPU: moonshot-v1-16b-a3b whole served through a 1 x 1 mesh on a
one-rank NCCL group against the same serve with no mesh, and the
dry-run's memory model over every cell on both production meshes, with
the path's launch gate.

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
    print(json.dumps({"launches": {"mesh": mesh}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
