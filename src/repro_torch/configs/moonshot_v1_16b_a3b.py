"""moonshot-v1-16b-a3b — Moonlight 16B-A3B MoE [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64 experts top-6.

Data copied from ``repro/configs/moonshot_v1_16b_a3b.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1408,
    vocab_size=163840,
    patterns=uniform_pattern("attn", 48),
    moe_experts=64, moe_top_k=6, moe_d_ff=1408,
    activation="silu", glu=True,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=32,
    vocab_size=512,
    patterns=uniform_pattern("attn", 2),
    moe_experts=8, moe_top_k=2, moe_d_ff=32,
    activation="silu", glu=True,
    param_dtype="float32", capacity_factor=8.0,
)

ARCH = ArchSpec(
    arch_id="moonshot-v1-16b-a3b", model=MODEL, smoke=SMOKE,
    source="hf:moonshotai/Moonlight-16B-A3B",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
