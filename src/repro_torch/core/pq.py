"""Product quantisation: Lloyd training, encoding, ADC and symmetric
distances (port of ``repro/core/pq.py``).

The products here (``train_pq``, ``encode``, ``sym_tables``) expect full
float32 matrix multiplies.  TF32 keeps about three decimal digits and
flips codes, so a caller on the card leaves
``torch.backends.cuda.matmul.allow_tf32`` (and cuDNN's flag) False, as
``chip_smoke.py`` does.

Symmetric (code-to-code) distances are ADC over the rows of the
cross-centroid table that ``code_a`` selects, so they route through the
same kernel (:func:`repro_torch.kernels.ops.adc_distance`) and sum over
subspaces in the same order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as jr
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass
class PQCodec:
    codebooks: torch.Tensor      # [M, 256, dsub] float32

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def _sqdist_to_centroids(sub: torch.Tensor, cents: torch.Tensor):
    """sub [M, S, dsub], cents [M, K, dsub] -> [M, S, K] squared L2 in the
    reference's expanded form."""
    return ((sub * sub).sum(-1)[:, :, None]
            - 2 * torch.bmm(sub, cents.transpose(1, 2))
            + (cents * cents).sum(-1)[:, None, :])


def train_pq(key: torch.Tensor, sample: torch.Tensor, m: int,
             iters: int = 8) -> PQCodec:
    """Lloyd k-means per subspace.  sample: [S, D]; D % m == 0."""
    s, d = sample.shape
    assert d % m == 0, (d, m)
    dsub = d // m
    sub = sample.reshape(s, m, dsub).transpose(0, 1).contiguous()
    init_idx = jr.choice(key, s, (256,), replace=s < 256).to(sample.device)
    cents = sub[:, init_idx]
    for _ in range(iters):
        assign = _sqdist_to_centroids(sub, cents).argmin(-1)        # [M, S]
        onehot = torch.nn.functional.one_hot(assign, 256).to(sub.dtype)
        sums = torch.bmm(onehot.transpose(1, 2), sub)               # [M,256,ds]
        counts = onehot.sum(1)[..., None]
        cents = torch.where(counts > 0, sums / counts.clamp(min=1), cents)
    return PQCodec(codebooks=cents)


def encode(codec: PQCodec, x: torch.Tensor, chunk: int = 8192
           ) -> torch.Tensor:
    """x: [N, D] -> codes uint8 [N, M] (in row chunks: the distance
    tensor is [M, chunk, 256])."""
    n = x.shape[0]
    out = torch.empty((n, codec.m), dtype=torch.uint8, device=x.device)
    for s in range(0, n, chunk):
        xb = x[s:s + chunk]
        sub = xb.reshape(xb.shape[0], codec.m, codec.dsub).transpose(0, 1)
        d2 = _sqdist_to_centroids(sub.contiguous(), codec.codebooks)
        out[s:s + chunk] = d2.argmin(-1).T.to(torch.uint8)
    return out


def adc_lut(codec: PQCodec, q: torch.Tensor) -> torch.Tensor:
    """Asymmetric-distance LUTs: q [D] -> [M, 256], or [B, D] -> [B, M, 256]."""
    qs = q.reshape(*q.shape[:-1], codec.m, 1, codec.dsub)
    return ((codec.codebooks - qs) ** 2).sum(-1)


def adc_distance(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """One query's LUT [M, 256] at codes [B, M] uint8 -> squared-L2
    estimates [B] (through the ADC kernel, as a wave of one)."""
    return kernel_ops.adc_distance(lut[None].contiguous(),
                                   codes[None].contiguous())[0]


def decode_codes(codec: PQCodec, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct PQ codes [N, M] into approximate vectors [N, M * dsub]:
    each subspace's centroid at its code."""
    ar = torch.arange(codec.m, device=codes.device)
    return codec.codebooks[ar, codes.long()].reshape(codes.shape[0], -1)


def exact_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 between q [..., D] and rows of x [..., B, D]."""
    diff = x - q.unsqueeze(-2)
    return (diff * diff).sum(-1)


def sym_tables(codec: PQCodec) -> torch.Tensor:
    """Cross-centroid distance tables T[m, a, b] = ||c_ma - c_mb||^2."""
    cb = codec.codebooks
    return _sqdist_to_centroids(cb, cb).clamp(min=0.0)


def sym_lut(tables: torch.Tensor, code_a: torch.Tensor) -> torch.Tensor:
    """The ADC table of ``code_a`` [..., M]: rows T[m, a_m] -> [..., M, 256]."""
    m = tables.shape[0]
    ar = torch.arange(m, device=tables.device)
    return tables[ar, code_a.long()]


def sym_distance(tables: torch.Tensor, code_a: torch.Tensor,
                 code_b: torch.Tensor) -> torch.Tensor:
    """Per lane, approx squared L2 of code_a [B, M] to code_b [B, C, M]
    -> [B, C]."""
    return kernel_ops.adc_distance(sym_lut(tables, code_a),
                                   code_b.contiguous())


def sym_distance_matrix(tables: torch.Tensor, codes: torch.Tensor,
                        chunk: int = 256) -> torch.Tensor:
    """All-pairs symmetric PQ distances for a code set [S, M] -> [S, S]."""
    s = codes.shape[0]
    out = torch.empty((s, s), dtype=tables.dtype, device=codes.device)
    for a in range(0, s, chunk):
        ca = codes[a:a + chunk]
        out[a:a + chunk] = sym_distance(
            tables, ca, codes[None].expand(ca.shape[0], -1, -1))
    return out
