"""qwen2-0.5b — dense GQA with QKV bias [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

Data copied from ``repro/configs/qwen2_0_5b.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, d_ff=4864,
    vocab_size=151936,
    patterns=uniform_pattern("attn", 24),
    qkv_bias=True, tie_embeddings=True,
    activation="silu", glu=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512,
    patterns=uniform_pattern("attn", 2),
    qkv_bias=True, tie_embeddings=True,
    activation="silu", glu=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="qwen2-0.5b", model=MODEL, smoke=SMOKE,
    source="arXiv:2407.10671",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
