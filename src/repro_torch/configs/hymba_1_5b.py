"""hymba-1.5b — hybrid parallel attention+Mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba runs attention and SSM heads in parallel inside each layer and fuses
the (per-branch normalised) outputs.  Most layers use sliding-window
attention; layers {0, 15, 31} are global (first/middle/last, per the paper).

Data copied from ``repro/configs/hymba_1_5b.py``.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig, Pattern, StageSpec

_WINDOW = 1024

MODEL = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, d_ff=5504,
    vocab_size=32001,
    patterns=(Pattern(1, (
        StageSpec("hybrid", 1, 0),           # layer 0: global
        StageSpec("hybrid", 14, _WINDOW),    # layers 1..14: local
        StageSpec("hybrid", 1, 0),           # layer 15: global
        StageSpec("hybrid", 15, _WINDOW),    # layers 16..30: local
        StageSpec("hybrid", 1, 0),           # layer 31: global
    )),),
    ssm_state=16, d_inner=3200, dt_rank=100, conv_kernel=4,
    activation="silu", glu=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512,
    patterns=(Pattern(1, (
        StageSpec("hybrid", 1, 0),
        StageSpec("hybrid", 2, 16),
        StageSpec("hybrid", 1, 0),
    )),),
    ssm_state=8, d_inner=128, dt_rank=16, conv_kernel=4,
    activation="silu", glu=True, tie_embeddings=True,
    param_dtype="float32", capacity_factor=8.0,
)

ARCH = ArchSpec(
    arch_id="hymba-1.5b", model=MODEL, smoke=SMOKE,
    source="arXiv:2411.13676; hf",
    # sliding-window + SSM state => sub-quadratic; long_500k runs.
)
