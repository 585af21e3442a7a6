"""llama-3.2-vision-90b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Every 5th layer
is a gated cross-attention layer over precomputed vision-patch embeddings
(the vision tower is a stub per the assignment; ``input_specs()`` provides
[B, 6404, 8192] patch embeddings = 4 tiles × 1601 patches).

Data copied from ``repro/configs/llama_3_2_vision_90b.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, Pattern, StageSpec

MODEL = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8, d_ff=28672,
    vocab_size=128256,
    patterns=(Pattern(20, (StageSpec("attn", 4, 0),
                           StageSpec("cross", 1, 0))),),
    cross_seq=6404,
    activation="silu", glu=True, rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512,
    patterns=(Pattern(1, (StageSpec("attn", 4, 0),
                          StageSpec("cross", 1, 0))),),
    cross_seq=12,
    activation="silu", glu=True,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="llama-3.2-vision-90b", model=MODEL, smoke=SMOKE,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
