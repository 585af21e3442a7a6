"""Per-device FLOPs, memory traffic and collectives of one step, counted on
meta tensors (port of ``repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO of a compiled step.  Eager PyTorch
has no compiled program, so :func:`analyze` runs the step once on meta
tensors (shapes and dtypes, no data, no device) under a dispatch mode that
sees every aten operation the step issues, and over a counting
``launch.mesh.Mesh`` that counts every collective it would run.  Every
figure is one device's per step: the tensors are rank 0's blocks and
rows, as the reference's partitioned HLO is the one program every device
runs.

- ``dot_flops``: the products the reference counts as ``dot`` (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions, the fused attentions) at
  2 x |out| x |contracted|: ``torch.utils.flop_counter``'s table, which
  counts exactly that set.
- ``hbm_traffic_bytes``: what eager moves.  Every operation the step
  issues on the device is a kernel of its own, reading its operands from
  memory and writing its results there (eager fuses nothing), so each
  counts its tensor operands' bytes plus its results' bytes: the eager
  counterpart of the reference's "fusion boundaries" rule.  Views,
  reshapes, allocations and other metadata operations move nothing and
  count nothing (nor are they ops); an in-place operation reads and
  writes its target.  Work on host tensors is not the device's.
- ``collectives``: ``{"bytes_by_kind", "op_counts"}`` by the reference's
  kinds (the mesh's ``kinds``: result bytes, twice that for an
  all-reduce), plus ``by_part`` (``Mesh.parts``: calls and the bytes
  handed to them).
- ``n_ops`` (in place of the reference's ``n_computations``): the
  operations counted, and ``max_trip``: the largest trip count multiplied
  out.

Trip counts: the port writes its stacks and scans as Python loops
(``repro_torch.trips``).  A stage's layers (which share shapes), the
selective scan's chunks and time steps and the optimizer's stack slices
run one iteration per group of equal shapes, counted times the group's
size, as the reference multiplies a while body by its trip count; the
counts equal those of running every iteration (``collapse=False``).
While a loop is collapsed, the zeros that autograd fills in for the
gradients of the layers it did not run are not counted.

No peak figure of any device is here: shares of a peak are a benchmark's
to take.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import trips
from repro_torch.launch.mesh import kind_record, new_kinds
from repro_torch.tree import tree_leaves

aten = torch.ops.aten

# operations that allocate and move nothing, and the view that its schema
# does not mark as one (the others are found by their schema)
_FREE = frozenset({
    aten.empty.memory_format, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.empty_like.default, aten._unsafe_view.default,
})
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.abspath(__file__), os.path.join(_PACKAGE, "trips.py"),
         os.path.join(_PACKAGE, "launch", "mesh.py"))


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """The innermost frame of the port's own code (but this module, the
    trips and the mesh) that issued the work being counted, or the
    autograd node whose backward did."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward {type(node).__name__}"
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PACKAGE) and path not in _SKIP:
            return (f"{os.path.relpath(path, _PACKAGE)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


class _Counter(TorchDispatchMode):
    """Counts the operations issued on the meta device, each times
    ``trips.multiplier()``; ``sites``: also by (op, issuing site)."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.dot_flops = self.traffic = self.n_ops = 0
        self.sites: dict | None = {} if sites else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # a composite (``matmul`` without autograd) counts as the ops
            # it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func in _FREE or func.is_view:
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not any(t.is_meta for t in ins + outs):
            return out
        if (trips.is_collapsing() and func is aten.zeros.default and
                type(torch._C._current_autograd_node()).__name__
                == "UnbindBackward0"):
            return out
        m = trips.multiplier()
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            self.dot_flops += flops(*args, **kwargs, out_val=out) * m
        moved = sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        self.traffic += moved * m
        self.n_ops += m
        if self.sites is not None:
            key = (str(func._overloadpacket).replace("aten.", ""), _site())
            c = self.sites.setdefault(key, [0, 0])
            c[0] += moved * m
            c[1] += m
        return out


def _collectives(mesh) -> dict:
    if mesh is None:
        return dict(kind_record(new_kinds()), by_part={})
    return dict(kind_record(mesh.kinds), by_part={
        k: dict(v) for k, v in sorted(mesh.parts.items())})


def _run(fn, args, mesh, collapse: bool, sites: bool):
    if mesh is not None and not mesh.counting:
        raise ValueError(f"{mesh!r} is not a counting mesh "
                         "(Mesh(..., virtual=True, counting=True))")
    if collapse and not all(t.is_meta for t in tree_leaves(args)
                            if isinstance(t, torch.Tensor)):
        raise ValueError("a collapsed analysis runs on meta tensors only")
    if mesh is not None:
        mesh.reset_stats()
    counter = _Counter(sites)
    with trips.collapsing(collapse), counter:
        fn(*args)
        max_trip = trips.max_trip()
    return counter, max_trip


def analyze(fn, *args, mesh=None, collapse: bool = True) -> dict:
    """``fn(*args)`` run once on meta tensors (``args`` hold them), its
    collectives through ``mesh`` (a counting mesh, or None for a step
    with none): the reference's fields, per device per step.
    ``collapse``: multiply repeated iterations out (``trips``) rather
    than run them all."""
    counter, max_trip = _run(fn, args, mesh, collapse, sites=False)
    return {"dot_flops": int(counter.dot_flops),
            "hbm_traffic_bytes": int(counter.traffic),
            "collectives": _collectives(mesh),
            "n_ops": int(counter.n_ops), "max_trip": max_trip}


def top_contributors(fn, *args, mesh=None, kind: str = "traffic",
                     n: int = 20) -> list[tuple[int, str]]:
    """The ``n`` largest contributors to ``fn(*args)``'s traffic (``kind``
    "traffic": bytes by operation and the site in the port's code, or the
    autograd node, that issued it) or its collectives ("collective": wire
    bytes by kind, part and site), each ``(bytes, label)`` with its count
    of calls in the label, largest first."""
    if kind not in ("traffic", "collective"):
        raise ValueError(f"kind {kind!r}: 'traffic' or 'collective'")
    found: dict = {}
    if kind == "collective":
        if mesh is None:
            return []

        def trace(ck, part, wire):
            c = found.setdefault((ck, part, _site()), [0, 0])
            c[0] += wire
            c[1] += trips.multiplier()
        mesh.trace = trace
        try:
            _run(fn, args, mesh, True, sites=False)
        finally:
            mesh.trace = None
        rows = [(b, f"{ck} {part} x{c} {site}")
                for (ck, part, site), (b, c) in found.items()]
    else:
        counter, _ = _run(fn, args, mesh, True, sites=True)
        rows = [(b, f"{op} x{c} {site}")
                for (op, site), (b, c) in counter.sites.items()]
    rows.sort(key=lambda r: (-r[0], r[1]))
    return rows[:n]
