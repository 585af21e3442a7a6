"""Device-dispatched wrappers for the three hot-spot kernels (port of
``repro/kernels/ops.py``).

==============  ===================================================
tensor device   implementation
==============  ===================================================
cpu             the plain versions in :mod:`repro_torch.kernels.ref`
cuda            the hand-written CUDA kernels in ``csrc/`` (built by
                :mod:`repro_torch.kernels._build` at the first call)
==============  ===================================================

For a CUDA tensor a wrapper launches its kernel or raises: a build or
launch error surfaces, nothing falls back.  The one other route is
:func:`plain_on_device`, which ``chip_smoke.py``'s A/B phase uses to run
the plain versions on the card; no port module uses it.

Each wrapper adds one to ``launches[name]`` where it launches its kernel,
and nowhere else, so a run can show that the main path went through the
kernels.  Kernels launch on the current stream and allocate nothing; the
wrapper checks device, dtype, shape and contiguity and allocates the
outputs.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ref

launches = {"pool_merge": 0, "adc_distance": 0, "rerank_l2": 0}
_plain_on_device = False


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def plain_on_device():
    """Run the plain versions on CUDA tensors too (A/B comparisons only)."""
    global _plain_on_device
    prev, _plain_on_device = _plain_on_device, True
    try:
        yield
    finally:
        _plain_on_device = prev


def _use_plain(*tensors: torch.Tensor) -> bool:
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"kernel inputs on unsupported or mixed devices: "
                         f"{[str(t.device) for t in tensors]}")
    return _plain_on_device


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-d {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _call(fn_name: str, *args) -> None:
    from repro_torch.kernels import _build
    err = getattr(_build.library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def adc_distance(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [B, M, 256] f32; codes [B, C, M] uint8 -> [B, C] PQ distances."""
    if _use_plain(lut, codes):
        return ref.adc_distance_ref(lut, codes)
    _check(lut, "lut", torch.float32, 3)
    _check(codes, "codes", torch.uint8, 3)
    b, m, k = lut.shape
    c = codes.shape[1]
    if k != 256 or codes.shape[0] != b or codes.shape[2] != m:
        raise ValueError(f"adc_distance shapes: lut {tuple(lut.shape)}, "
                         f"codes {tuple(codes.shape)}")
    if m * 256 * 4 > 227 * 1024 or lut.data_ptr() % 16 or b > 65535:
        raise ValueError("adc_distance: the LUT must fit shared memory "
                         "(M <= 227) and be 16-byte aligned, and B <= 65535 "
                         "(one grid row per lane)")
    out = torch.empty((b, c), dtype=torch.float32, device=lut.device)
    if b and c:
        _call("adc_distance_launch", lut.data_ptr(), codes.data_ptr(),
              out.data_ptr(), b, c, m, _stream(lut))
        launches["adc_distance"] += 1
    return out


def rerank_l2(q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """q [B, D] f32; xs [B, S, D] f32 -> [B, S] exact squared L2."""
    if _use_plain(q, xs):
        return ref.rerank_l2_ref(q, xs)
    _check(q, "q", torch.float32, 2)
    _check(xs, "xs", torch.float32, 3)
    b, s, d = xs.shape
    if q.shape != (b, d):
        raise ValueError(f"rerank_l2 shapes: q {tuple(q.shape)}, "
                         f"xs {tuple(xs.shape)}")
    out = torch.empty((b, s), dtype=torch.float32, device=q.device)
    if b and s:
        _call("rerank_l2_launch", q.data_ptr(), xs.data_ptr(),
              out.data_ptr(), b, s, d, _stream(q))
        launches["rerank_l2"] += 1
    return out


def pool_merge(pool_d, pool_ids, new_d, new_ids):
    """Per lane, keep the P smallest of pool [B, P] ∪ new [B, Q], ascending
    and stable on ties -> (d [B, P] f32, ids [B, P] int32)."""
    if _use_plain(pool_d, pool_ids, new_d, new_ids):
        return ref.pool_merge_ref(pool_d, pool_ids, new_d, new_ids)
    for t, name, dt in ((pool_d, "pool_d", torch.float32),
                        (pool_ids, "pool_ids", torch.int32),
                        (new_d, "new_d", torch.float32),
                        (new_ids, "new_ids", torch.int32)):
        _check(t, name, dt, 2)
    b, p = pool_d.shape
    q = new_d.shape[1]
    if pool_ids.shape != (b, p) or new_d.shape[0] != b or \
            new_ids.shape != (b, q):
        raise ValueError("pool_merge: mismatched shapes")
    if p + q > 1024:
        raise ValueError(f"pool_merge: P + Q = {p + q} > 1024")
    out_d = torch.empty((b, p), dtype=torch.float32, device=pool_d.device)
    out_i = torch.empty((b, p), dtype=torch.int32, device=pool_d.device)
    if b and p:
        _call("pool_merge_launch", pool_d.data_ptr(), pool_ids.data_ptr(),
              new_d.data_ptr(), new_ids.data_ptr(), out_d.data_ptr(),
              out_i.data_ptr(), b, p, q, _stream(pool_d))
        launches["pool_merge"] += 1
    return out_d, out_i
