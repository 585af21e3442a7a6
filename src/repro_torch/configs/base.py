"""Architecture and input-shape specification types shared by all configs
(port of ``repro/configs/base.py``; pure data)."""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


# The four assigned LM shapes.  ``decode_*`` / ``long_*`` are one new
# token against a seq_len KV cache.
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

FULL_ATTENTION_SKIP = ("pure full-attention architecture: a 500k-token dense "
                       "KV has no sub-quadratic state; skipped per assignment "
                       "rule (see DESIGN.md §Shape-coverage)")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An assigned architecture: exact config + reduced smoke twin."""

    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    optimizer: str = "adamw"            # adamw | adafactor
    opt_state_dtype: str = "bfloat16"
    skip_shapes: Mapping[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""

    def runs(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes
