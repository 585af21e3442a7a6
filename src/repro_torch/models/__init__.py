"""The LM substrate's models on PyTorch (port of ``repro/models``).

``config`` holds the configuration types, ``layers`` the plain layer
functions, ``transformer`` the parameter tree, the forward pass, the
training loss, prefill and decode, for every stage kind (``attn``,
``attn_cross``, ``cross``, ``mamba``, ``hybrid``, ``enc``) and FFN (dense,
MoE, MoE + dense) of the ten assigned architectures, on one device or
over a ``launch.mesh.Mesh``.
"""
