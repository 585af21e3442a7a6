"""Device resolution and an environment probe (no reference counterpart).

The rule every entry point follows: run on ``cuda`` unless the caller
passes ``device="cpu"`` (as the CPU tests do).  With no card and no
explicit ``"cpu"`` the call raises — the port never carries on silently
on the host.
"""
from __future__ import annotations

import os
import shutil
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev


def nvcc_path() -> str | None:
    """The CUDA compiler: on PATH, else under /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else None


def env_probe() -> dict:
    """torch/CUDA versions, the card's name and whether nvcc is present."""
    nvcc = nvcc_path()
    nvcc_version = None
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=False).stdout.strip()
        nvcc_version = out.splitlines()[-1] if out else None
    has_card = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if has_card else None,
        "device_count": torch.cuda.device_count() if has_card else 0,
        "nvcc": nvcc,
        "nvcc_version": nvcc_version,
    }
