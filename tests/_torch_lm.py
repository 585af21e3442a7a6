"""Helpers the port's LM test modules share."""
import jax.numpy as jnp

GATES = (0.7, -0.4)     # tanh gate values of the cross layers in the tests


def with_gates(tree, gates=GATES):
    """The reference's parameter tree with every cross layer's
    ``gate_attn`` and ``gate_mlp`` set to ``gates`` (zero at init, where
    the layer adds nothing)."""
    if isinstance(tree, list):
        return [with_gates(v, gates) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: with_gates(v, gates) for k, v in tree.items()}
    if "gate_attn" in out:
        out["gate_attn"] = jnp.full_like(out["gate_attn"], gates[0])
        out["gate_mlp"] = jnp.full_like(out["gate_mlp"], gates[1])
    return out
