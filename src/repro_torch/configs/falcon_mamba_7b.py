"""falcon-mamba-7b — attention-free Mamba-1 [arXiv:2410.05355].

64L d_model=4096, d_inner=8192, ssm_state=16, dt_rank=256, vocab=65024.
No attention, no separate MLP: each layer is a Mamba mixer block.
long_500k runs (O(1) recurrent state).

Data copied from ``repro/configs/falcon_mamba_7b.py``.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, uniform_pattern

MODEL = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1, d_ff=0,
    vocab_size=65024,
    patterns=uniform_pattern("mamba", 64),
    ssm_state=16, d_inner=8192, dt_rank=256, conv_kernel=4,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    num_layers=3, d_model=64, num_heads=1, num_kv_heads=1, d_ff=0,
    vocab_size=512,
    patterns=uniform_pattern("mamba", 3),
    ssm_state=8, d_inner=128, dt_rank=16, conv_kernel=4,
    param_dtype="float32",
)

ARCH = ArchSpec(
    arch_id="falcon-mamba-7b", model=MODEL, smoke=SMOKE,
    source="arXiv:2410.05355",
)
