"""Fault-tolerant checkpointing: atomic commit and resume (port of
``repro/checkpoint/store.py``, in the same on-disk format).

Layout on disk::

    <dir>/step_00000100/
        shard_00000.npz        the flattened leaves, each as raw uint8
        MANIFEST.json          step, n_leaves, names, shapes, dtypes
    <dir>/LATEST               text file naming the last COMMITTED step dir

Leaves are flattened in JAX's order (:mod:`repro_torch.tree`) and named
by their path (``params/blocks/0/0/attn/wq``), so a checkpoint of either
package loads into the other leaf for leaf.  A leaf is stored as its raw
bytes (``tensor.view(torch.uint8)``) and read back through
``torch.frombuffer`` viewed as the manifest's dtype; bfloat16 needs no
``ml_dtypes``.

Commit protocol: write into ``step_X.tmp/``, fsync, rename to ``step_X/``,
then rewrite ``LATEST``: a crash at any point leaves either the previous
checkpoint or a complete new one (``*.tmp`` dirs are removed by the next
save).  The reference's elastic remesh (re-placing each leaf under
another mesh's sharding) waits for training over a mesh (ROADMAP.md
queue 1 item 5.7); ``load`` places the leaves on one device.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten_with_path, tree_unflatten


def _leaves_with_names(tree) -> tuple[list[str], list]:
    flat = list(tree_flatten_with_path(tree))
    return (["/".join(map(str, path)) for path, _ in flat],
            [leaf for _, leaf in flat])


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype (``float32``, ``bfloat16``, ...),
    as the reference's manifest writes it."""
    return str(t.dtype).removeprefix("torch.")


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    t = torch.as_tensor(t).detach().to("cpu").contiguous()
    return t.reshape(-1).view(torch.uint8).numpy()


def save(ckpt_dir: str | Path, step: int, tree: Any, *, keep: int = 3,
         shard: int = 0) -> Path:
    """Atomically persist ``tree`` (tensors in nested dicts and lists) for
    ``step``.  Returns the commit dir."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    names, leaves = _leaves_with_names(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    arrays = {f"leaf_{i:05d}": _raw_bytes(x) for i, x in enumerate(leaves)}
    shard_file = tmp / f"shard_{shard:05d}.npz"
    np.savez(shard_file, **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "names": names,
        "shapes": [list(x.shape) for x in leaves],
        "dtypes": [_dtype_name(x) for x in leaves],
    }
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    # fsync the shard file then atomically publish
    with open(shard_file, "rb") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (ckpt_dir / "LATEST.tmp").write_text(final.name)
    (ckpt_dir / "LATEST.tmp").rename(ckpt_dir / "LATEST")

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(d for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and not d.name.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    for d in ckpt_dir.glob("*.tmp"):
        if d.is_dir():
            shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    latest = ckpt_dir / "LATEST"
    if not latest.exists():
        return None
    name = latest.read_text().strip()
    if not (ckpt_dir / name / "MANIFEST.json").exists():
        return None          # torn commit: fall back to scanning
    return int(name.split("_")[1])


def _leaf(raw: np.ndarray, dtype: str, shape: list[int]) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if raw.size == 0:
        return torch.empty(shape, dtype=dt)
    return torch.frombuffer(raw, dtype=torch.uint8).view(dt).reshape(shape)


def load(ckpt_dir: str | Path, step: int, like: Any, *, shard: int = 0,
         device=None) -> Any:
    """Restore the tree saved at ``step``: ``like`` supplies the structure
    (its leaves are not read), the manifest each leaf's dtype and shape;
    the leaves are placed on ``device``.  The leaf names must match
    ``like``'s."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    names, like_leaves = _leaves_with_names(like)
    if manifest["names"] != names:
        raise ValueError(
            f"checkpoint {d} holds leaves {manifest['names'][:4]}..., "
            f"expected {names[:4]}... ({manifest['n_leaves']} against "
            f"{len(like_leaves)})")
    with np.load(d / f"shard_{shard:05d}.npz") as data:
        leaves = [_leaf(data[f"leaf_{i:05d}"], manifest["dtypes"][i],
                        manifest["shapes"][i]).to(dev)
                  for i in range(manifest["n_leaves"])]
    return tree_unflatten(like, leaves)


def load_latest(ckpt_dir: str | Path, like: Any, *, shard: int = 0,
                device=None):
    """(step, tree) of the newest committed checkpoint, or (None, None)."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, None
    return step, load(ckpt_dir, step, like, shard=shard, device=device)
