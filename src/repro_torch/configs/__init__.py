"""Architecture registry: ``--arch <id>`` resolution and per-cell input
specs (port of ``repro/configs/__init__.py``).

Every assigned architecture is importable here; ``get_arch`` accepts the
dashed public id.  The configurations are data: importing them builds no
model.  ``input_specs`` builds a dry-run cell's inputs on the meta device
(shapes and dtypes, no memory).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec, SHAPES  # noqa: F401
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    falcon_mamba_7b,
    gemma3_1b,
    gemma_2b,
    hymba_1_5b,
    llama_3_2_vision_90b,
    moonshot_v1_16b_a3b,
    qwen1_5_0_5b,
    qwen2_0_5b,
    whisper_medium,
)

_MODULES = (
    hymba_1_5b, moonshot_v1_16b_a3b, arctic_480b, whisper_medium,
    qwen1_5_0_5b, qwen2_0_5b, gemma3_1b, gemma_2b, falcon_mamba_7b,
    llama_3_2_vision_90b,
)

REGISTRY: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ARCH_IDS)}")
    return REGISTRY[arch_id]


def cells(include_skipped: bool = False):
    """Every assigned (arch × shape) cell, with skip reasons."""
    for arch_id, arch in REGISTRY.items():
        for shape_name, shape in SHAPES.items():
            reason = arch.skip_shapes.get(shape_name)
            if reason is None or include_skipped:
                yield arch_id, shape_name, reason


def input_specs(arch: ArchSpec, shape: ShapeSpec, *, smoke: bool = False,
                rules=None) -> dict:
    """A dry-run cell's step inputs as meta tensors: ``tokens`` (and the
    cross source of a model with cross layers) for train and prefill;
    for decode one new token, ``pos`` and the ``seq_len``-long caches
    (``transformer.cache_shapes``)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import NO_SHARD

    cfg = arch.smoke if smoke else arch.model
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = meta((B, S), torch.int32)
        if cfg.cross_seq:
            specs["cross_src"] = meta((B, cfg.cross_seq, cfg.d_model),
                                      cfg.dtype)
    else:  # decode: one new token against an S-long cache
        specs["tokens"] = meta((B, 1), torch.int32)
        specs["pos"] = meta((), torch.int32)
        specs["cache"] = T.cache_shapes(cfg, B, S, rules or NO_SHARD)
    return specs
