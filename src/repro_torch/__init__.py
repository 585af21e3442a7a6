"""NAVIS on PyTorch and CUDA: a port of the ``repro`` JAX package.

Module for module it follows ``repro`` (``core/``, ``kernels/``,
``data/``); each file names the reference file it answers to.  It imports
``torch`` and never JAX or anything of ``repro``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see
:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import env_probe, resolve_device

__all__ = ["env_probe", "resolve_device"]
