"""qwen1.5-0.5b — dense with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.

Data copied from ``repro/configs/qwen1_5_0_5b.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, d_ff=2816,
    vocab_size=151936,
    patterns=uniform_pattern("attn", 24),
    qkv_bias=True, tie_embeddings=True,
    activation="silu", glu=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=512,
    patterns=uniform_pattern("attn", 2),
    qkv_bias=True, tie_embeddings=True,
    activation="silu", glu=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="qwen1.5-0.5b", model=MODEL, smoke=SMOKE,
    source="hf:Qwen/Qwen1.5-0.5B",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
