"""The traced part of a ``--trace 1`` run: the device's busy time, its
operations by name, its idle gaps by what the host was doing, and the
shapes of the ``adc_distance`` launches.

The measurement is ``chip_smoke.profile_window``'s: ``torch.profiler``
with CUDA activity only (recording every host operator too would slow the
host the idle share is measured against), around work that ends in a
sync.  Here it is read from the profiler's raw events rather than
``key_averages``, so that busy time is the union of the device's
intervals and the gaps between them can be placed on the host's spans.

A run traces ``steps`` step boundaries of its loop (a wave of the closed
loop), from the first boundary at or after ``start_frac`` of the window.
Once the profiler has run, every launch of the process costs more (a
loop of insert and search waves completed 45% fewer of them in a traced
run whose trace began at a fifth of the window), so the trace sits near
the window's end and the spans' readers take the calls before it
(``Record.timed_ops``).
"""
from __future__ import annotations

import bisect
import time

import torch

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
TOP = 10                      # entries of each breakdown list
NAME_CHARS = 120


def kernel_name(raw: str) -> str:
    """A profiler row's kernel name without ``void`` and arguments."""
    name = raw.removeprefix("void ")
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name[:NAME_CHARS]


def adc_bytes(lut_shape, codes_shape) -> int:
    """Bytes one ``adc_distance`` launch must move, each once: the lanes'
    LUTs [B, M, 256] f32, their codes [B, C, M] u8 and the [B, C] f32
    distances."""
    b, m, k = lut_shape
    c = codes_shape[1]
    return b * m * k * 4 + b * c * m + b * c * 4


class Tracer:
    """Starts and stops the profiler at the loop's step boundaries."""

    def __init__(self, on: bool, device: torch.device, seconds: float,
                 start_frac: float, steps: int):
        self.on = on and device.type == "cuda"
        self.device = device
        self.start_at = start_frac * seconds
        self.steps = steps
        self._prof = None
        self._seen = 0
        self._done = False
        self._t0_ns = self._t1_ns = 0
        self.started_at: float | None = None     # perf_counter seconds
        self._offset_ns = 0
        self._shapes: list = []
        self._saved_adc = None
        self.summary: dict | None = None

    def boundary(self, elapsed_s: float, spans: list) -> None:
        """Called by a loop between steps, with the device synced."""
        if not self.on or self._done:
            return
        if self._prof is None:
            if elapsed_s >= self.start_at:
                self._start()
            return
        self._seen += 1
        if self._seen >= self.steps:
            self.stop(spans)

    def _start(self) -> None:
        from repro_torch.kernels import ops
        self._saved_adc = ops.adc_distance

        def adc_distance(lut, codes):
            self._shapes.append((tuple(lut.shape), tuple(codes.shape)))
            return self._saved_adc(lut, codes)

        ops.adc_distance = adc_distance
        act = torch.profiler.ProfilerActivity
        self.started_at = time.perf_counter()
        self._prof = torch.profiler.profile(activities=[act.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._t0_ns = time.time_ns()

    def stop(self, spans: list) -> None:
        """End the trace (at the window's end at the latest)."""
        if self._prof is None or self._done:
            return
        from repro_torch.kernels import ops
        torch.cuda.synchronize(self.device)
        self._t1_ns = time.time_ns()
        self._prof.stop()
        ops.adc_distance = self._saved_adc
        self._done = True
        self.summary = self._summarise(spans)
        self._prof = None

    def _summarise(self, spans: list) -> dict:
        cuda = torch.autograd.DeviceType.CUDA
        t0, t1 = self._t0_ns, self._t1_ns
        evs = [(e.name(), max(e.start_ns(), t0), min(e.end_ns(), t1))
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        evs = [e for e in evs if e[2] > e[1]]
        by_name: dict = {}
        for name, s, e in evs:
            k = kernel_name(name)
            tot = by_name.setdefault(k, [0.0, 0])
            tot[0] += (e - s) / 1e9
            tot[1] += 1
        # the union of the device's intervals, and the gaps between them
        busy_ns, gaps, end = 0, [], t0
        for _, s, e in sorted(evs, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, s))
            if e > end:
                busy_ns += e - max(s, end)
                end = e
        if t1 > end:
            gaps.append((end, t1))
        starts = [sp.t0 * 1e9 + self._offset_ns for sp in spans]
        order = sorted(range(len(spans)), key=lambda i: starts[i])
        sorted_starts = [starts[i] for i in order]
        idle: dict = {}
        for s, e in gaps:
            mid = (s + e) / 2
            name = "harness"
            j = bisect.bisect_right(sorted_starts, mid) - 1
            if j >= 0:
                sp = spans[order[j]]
                if sp.t1 * 1e9 + self._offset_ns >= mid:
                    name = sp.name
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        return {
            "busy_s": busy_ns / 1e9,
            "window_s": (t1 - t0) / 1e9,
            "kernels": by_name,
            "device_ops": [[k, v[0]] for k, v in top_ops[:TOP]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:TOP],
            "adc_calls": len(self._shapes),
            "adc_bytes": sum(adc_bytes(l, c) for l, c in self._shapes),
        }
