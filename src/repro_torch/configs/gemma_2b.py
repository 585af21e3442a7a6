"""gemma-2b — dense MQA with GeGLU and head_dim=256 [arXiv:2403.08295].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

Data copied from ``repro/configs/gemma_2b.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, d_ff=16384,
    vocab_size=256000, head_dim=256,
    patterns=uniform_pattern("attn", 18),
    activation="gelu", glu=True, norm_plus_one=True, embed_scale=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=32,
    patterns=uniform_pattern("attn", 2),
    activation="gelu", glu=True, norm_plus_one=True, embed_scale=True,
    tie_embeddings=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="gemma-2b", model=MODEL, smoke=SMOKE,
    source="arXiv:2403.08295",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
