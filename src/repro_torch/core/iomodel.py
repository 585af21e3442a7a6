"""I/O accounting + the SSD cost model (port of ``repro/core/iomodel.py``).

Every traversal / rerank / structural-update primitive threads an
:class:`IOCounters` through; benchmarks read exact per-category byte and
request counts, and :class:`SSDModel` turns them into time.  Counters are
int64 tensors, either scalars or with a leading lane dimension ``[B]``
(one tally per query of a wave).

The reference's ``HBMModel`` is a TPU v5e figure and is not carried over.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

PAGE_BYTES = 4096


@dataclasses.dataclass
class IOCounters:
    """Per-category I/O tallies (int64, scalar or ``[B]`` per lane)."""

    read_requests: torch.Tensor
    write_requests: torch.Tensor
    edge_bytes_read: torch.Tensor
    useful_vec_bytes_read: torch.Tensor
    wasted_vec_bytes_read: torch.Tensor
    pad_bytes_read: torch.Tensor
    edge_bytes_written: torch.Tensor
    vec_bytes_written: torch.Tensor
    wasted_vec_bytes_written: torch.Tensor
    pad_bytes_written: torch.Tensor
    cache_hits: torch.Tensor
    cache_misses: torch.Tensor
    hops: torch.Tensor
    visited_overflow: torch.Tensor
    tombstone_skips: torch.Tensor

    @classmethod
    def zeros(cls, shape=(), device=None) -> "IOCounters":
        device = resolve_device(device)
        return cls(*[torch.zeros(shape, dtype=torch.int64, device=device)
                     for _ in dataclasses.fields(cls)])

    def total_read_bytes(self):
        return (self.edge_bytes_read + self.useful_vec_bytes_read +
                self.wasted_vec_bytes_read + self.pad_bytes_read)

    def total_write_bytes(self):
        return (self.edge_bytes_written + self.vec_bytes_written +
                self.wasted_vec_bytes_written + self.pad_bytes_written)

    def map(self, fn) -> "IOCounters":
        return IOCounters(*[fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)])

    def asdict(self) -> dict:
        return {f.name: int(getattr(self, f.name))
                for f in dataclasses.fields(self)}


def merge_counters(a: IOCounters, b: IOCounters) -> IOCounters:
    return IOCounters(*[getattr(a, f.name) + getattr(b, f.name)
                        for f in dataclasses.fields(IOCounters)])


def sum_counters(batched: IOCounters) -> IOCounters:
    """Reduce per-lane counters ``[B]`` to one tally: concurrent readers
    charge I/O independently and the device serves the union."""
    return batched.map(lambda x: x.sum(dim=0))


@dataclasses.dataclass(frozen=True)
class SSDModel:
    """NVMe cost model (defaults ≈ the paper's Crucial T705 PCIe 5.0)."""

    read_iops: float = 1.40e6
    write_iops: float = 1.10e6
    read_bw: float = 13.6e9
    write_bw: float = 12.0e9
    request_latency: float = 55e-6
    queue_depth: int = 256

    def read_time(self, requests: float, bytes_: float) -> float:
        return max(requests / self.read_iops, bytes_ / self.read_bw)

    def write_time(self, requests: float, bytes_: float) -> float:
        return max(requests / self.write_iops, bytes_ / self.write_bw)

    def op_latency(self, requests: float, bytes_: float,
                   serial_rounds: float) -> float:
        return (serial_rounds * self.request_latency
                + self.read_time(requests, bytes_))
