"""Hand-written Hopper kernels for the engine's hot spots, each with a
plain PyTorch version (port of ``repro/kernels/__init__.py``).

  adc_distance — PQ ADC lookup-accumulate (every traversal hop)
  rerank_l2    — exact-L2 rerank of a CASR group
  pool_merge   — explored-pool merge (partial top-k)
"""
from repro_torch.kernels.ops import (adc_distance, launches, plain_on_device,
                                     pool_merge, rerank_l2, reset_launches)

__all__ = ["adc_distance", "launches", "plain_on_device", "pool_merge",
           "rerank_l2", "reset_launches"]
