"""Run the env phase and the training path of ``chip_smoke.py`` alone, on
one NVIDIA GPU: ``make_train_step`` for qwen2-0.5b at full width at the
smoke's two loads, hymba-1.5b and whisper-medium whole, the launcher's
crash and resume (``python -m repro_torch.launch.train``), the float32
checks against the host and the scan's backward against float64, with
the training path's launch gate.

    python3 tools/train_phase.py

It prints the phases' JSON lines, then the path's launch counts.  Use it
for a first chip call after a change to the training path.
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
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.kernels import ops
    try:
        smoke.phase_env(torch)
        train = smoke.train_path(torch, smoke.Paths(ops))
    except smoke.SmokeFailure as exc:
        print(f"train_phase: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"launches": {"train": train}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
