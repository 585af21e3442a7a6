"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of NAVIS.

Run one cell once with ``python3 navisbench/run.py`` (see its docstring);
``BENCHMARK.json`` at the repository's root names the cells, and the
harness finds each configuration, traffic mix and metric by name
(:mod:`navisbench.harness`).  It loads nothing of JAX or of the JAX
package ``repro``.
"""
