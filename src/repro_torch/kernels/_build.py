"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``, with the
headers they share, ``csrc/*.cuh``).

Each source is compiled by ``nvcc`` for ``sm_90a`` (all started together,
one process per source), linked into one shared library with a plain C
interface, and loaded with ``ctypes``.  The build runs at the first CUDA
call, into ``build/repro_torch_kernels/<hash>/`` under the repository
root, keyed by a hash of the sources, headers and flags, so a fresh checkout
builds it once and later calls reuse it.  ``ptxas.log`` beside the
library keeps each kernel's register and shared-memory report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from repro_torch.device import nvcc_path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: every pointer and the stream are void*, every int an int,
# every float a float
SIGNATURES = {
    "pool_merge_launch": [_P] * 7 + [_I] * 3 + [_P],
    "adc_distance_launch": [_P, _P, _P, _I, _I, _I, _P],
    "rerank_l2_launch": [_P, _P, _P, _I, _I, _I, _P],
    "rerank_l2_rows_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rerank_l2_shared_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "casr_rerank_launch": [_P] * 9 + [_I] * 6 + [_P],
    "casr_rerank_stages": [_P] + [_I] * 4,
    "cache_replay_launch": [_P] * 13 + [_I] * 6 + [_P],
    "cache_ops_launch": [_P] * 14 + [_I] * 6 + [_P],
    "entrance_search_launch": [_P] * 8 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = build_dir()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
