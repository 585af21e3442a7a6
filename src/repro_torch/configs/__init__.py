"""Architecture registry: ``--arch <id>`` resolution (port of
``repro/configs/__init__.py`` without ``input_specs``, the dry-run's,
which waits for ``launch/dryrun.py``).

Every assigned architecture is importable here; ``get_arch`` accepts the
dashed public id.  The configurations are data: importing them builds no
model.
"""
from __future__ import annotations

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
