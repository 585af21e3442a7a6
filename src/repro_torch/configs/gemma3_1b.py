"""gemma3-1b — dense with 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
sliding window 512 on local layers, GeGLU, RMSNorm(1+w), 128k-class rope.
26 = 4 × (5 local + 1 global) + 2 local.

long_500k runs: the 22 local layers keep only a 512-slot ring; the 4 global
layers hold full KV, and decode cost is linear per token.

Data copied from ``repro/configs/gemma3_1b.py``.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, Pattern, StageSpec

_WINDOW = 512

MODEL = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, d_ff=6912,
    vocab_size=262144, head_dim=256,
    patterns=(
        Pattern(4, (StageSpec("attn", 5, _WINDOW), StageSpec("attn", 1, 0))),
        Pattern(1, (StageSpec("attn", 2, _WINDOW),)),
    ),
    activation="gelu", glu=True, norm_plus_one=True, embed_scale=True,
    tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    num_layers=8, d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=32,
    patterns=(
        Pattern(2, (StageSpec("attn", 2, 16), StageSpec("attn", 1, 0))),
        Pattern(1, (StageSpec("attn", 2, 16),)),
    ),
    activation="gelu", glu=True, norm_plus_one=True, embed_scale=True,
    tie_embeddings=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="gemma3-1b", model=MODEL, smoke=SMOKE,
    source="hf:google/gemma-3-1b-pt",
)
