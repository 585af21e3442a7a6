"""Model configuration types (port of the configuration block of
``repro/models/transformer.py``: ``StageSpec``, ``Pattern``,
``ModelConfig``, ``uniform_pattern``).

Pure data, kept apart from the model code so that ``repro_torch.configs``
imports no layer.  ``ModelConfig.dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str       # attn | attn_cross | cross | mamba | hybrid | enc
    count: int
    window: int = 0           # 0 = global attention


@dataclasses.dataclass(frozen=True)
class Pattern:
    repeats: int
    stages: tuple[StageSpec, ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    patterns: tuple[Pattern, ...]
    head_dim: int = 0         # 0 -> d_model // num_heads
    qkv_bias: bool = False
    activation: str = "silu"
    glu: bool = True
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    norm_plus_one: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    max_position: int = 0     # >0 -> learned positions (whisper)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    conv_kernel: int = 4
    # cross-attention source (encoder frames / vision patches)
    cross_seq: int = 0
    encoder_layers: int = 0
    param_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def validate(self) -> None:
        n = sum(p.repeats * sum(s.count for s in p.stages)
                for p in self.patterns)
        if n != self.num_layers:
            raise ValueError(f"{self.name}: pattern layers {n} != "
                             f"num_layers {self.num_layers}")


def uniform_pattern(kind: str, n_layers: int, window: int = 0
                    ) -> tuple[Pattern, ...]:
    return (Pattern(1, (StageSpec(kind, n_layers, window),)),)
