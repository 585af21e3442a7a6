"""arctic-480b — Snowflake Arctic dense-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128 experts top-2 with a
parallel dense FFN residual, vocab=32000.  ~480B total parameters; trained
here with Adafactor (factored second moment) so optimizer state fits the
single-pod 16 GB/chip HBM budget (see DESIGN.md §5).

Data copied from ``repro/configs/arctic_480b.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, d_ff=4864,
    vocab_size=32000,
    patterns=uniform_pattern("attn", 35),
    moe_experts=128, moe_top_k=2, moe_d_ff=4864, moe_dense_residual=True,
    activation="silu", glu=True,
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, d_ff=64,
    vocab_size=512,
    patterns=uniform_pattern("attn", 2),
    moe_experts=8, moe_top_k=2, moe_d_ff=64, moe_dense_residual=True,
    activation="silu", glu=True,
    param_dtype="float32", capacity_factor=8.0,
)

ARCH = ArchSpec(
    arch_id="arctic-480b", model=MODEL, smoke=SMOKE,
    optimizer="adafactor",
    source="hf:Snowflake/snowflake-arctic-base",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
