"""whisper-medium — encoder-decoder audio transformer [arXiv:2212.04356].

24L (decoder; + 24L encoder) d_model=1024 16H d_ff=4096 vocab=51865.
The conv frontend is a stub per the assignment: ``input_specs()`` provides
precomputed 1500-frame embeddings.  LayerNorm + GELU + learned positions,
per the original architecture.  ``max_position`` is widened to 32k so the
assigned prefill/decode shapes are well-defined.

Data copied from ``repro/configs/whisper_medium.py``.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
    vocab_size=51865,
    patterns=uniform_pattern("attn_cross", 24),
    encoder_layers=24, cross_seq=1500,
    norm="layernorm", norm_eps=1e-5, activation="gelu", glu=False,
    use_rope=False, max_position=32_768,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=512,
    patterns=uniform_pattern("attn_cross", 2),
    encoder_layers=2, cross_seq=12,
    norm="layernorm", norm_eps=1e-5, activation="gelu", glu=False,
    use_rope=False, max_position=64,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="whisper-medium", model=MODEL, smoke=SMOKE,
    source="arXiv:2212.04356",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP},
)
