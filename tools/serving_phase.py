"""Run the env phase and the serving path of ``chip_smoke.py`` alone, on
one NVIDIA GPU: qwen2-0.5b at full width served at the smoke's loads, the
float32 check against the host, the chunked-attention check and the RAG
wave, with the serving path's launch gates.

    python3 tools/serving_phase.py

It prints the phases' JSON lines, then the two paths' launch counts
(about 50 s of command time).  Use it for a first chip call after a
change to the LM substrate.
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
        print("serving_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.kernels import ops
    try:
        smoke.phase_env(torch)
        serving, rag = smoke.serving_path(torch, smoke.Paths(ops))
    except smoke.SmokeFailure as exc:
        print(f"serving_phase: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"launches": {"serving": serving, "rag": rag}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
