"""The LM substrate's models on PyTorch (port of ``repro/models``).

``config`` holds the configuration types, ``layers`` the plain layer
functions, ``transformer`` the parameter tree, the forward pass, prefill
and decode.  Only the ``attn`` stage kind with a dense MLP is ported.
"""
