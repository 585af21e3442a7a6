"""Plain PyTorch versions of the three kernels (port of
``repro/kernels/ref.py``).

Batch-first: every function takes a leading lane dimension ``[B]`` (one
query of a wave per lane).  They are what :mod:`repro_torch.kernels.ops`
runs for tensors on the CPU, and what ``chip_smoke.py`` holds the CUDA
kernels against on the card.  They keep the input dtype.

``adc_distance_ref`` sums the subspaces one at a time in order ``m = 0,
1, ...``, as the TPU kernel's ``fori_loop`` does and as the CUDA kernel
does, so kernel and plain version agree bit for bit.  ``pool_merge_ref``
is a stable argsort, the TPU kernel's rank definition.
"""
from __future__ import annotations

import torch

INF = 3.4e38


def adc_distance_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [B, M, 256]; codes [B, C, M] uint8 -> [B, C]."""
    vals = lut.gather(2, codes.transpose(1, 2).long())      # [B, M, C]
    acc = torch.zeros_like(vals[:, 0])
    for m in range(vals.shape[1]):
        acc = acc + vals[:, m]
    return acc


def rerank_l2_ref(q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """q [B, D]; xs [B, S, D] -> [B, S] squared L2 (difference form)."""
    diff = xs - q[:, None]
    return (diff * diff).sum(-1)


def pool_merge_ref(pool_d, pool_ids, new_d, new_ids):
    """Keep the P smallest of each lane's ``pool ∪ new`` (stable on ties).
    pool [B, P], new [B, Q] -> ([B, P], [B, P]) ascending."""
    p = pool_d.shape[1]
    d = torch.cat([pool_d, new_d], dim=1)
    ids = torch.cat([pool_ids, new_ids], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :p]
    return d.gather(1, order), ids.gather(1, order)
