"""Serving steps: prefill (prompt -> cache) and decode (one token) (port of
``repro/train/serve_step.py``).  Both run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import NO_SHARD


def make_prefill_step(cfg: T.ModelConfig, *, rules=NO_SHARD, mesh=None,
                      max_seq: int | None = None):
    """``prefill_step(params, tokens, cross_src=None) -> (logits [B, V]
    float32, cache)``; ``cross_src`` is whisper's frames or llama-vision's
    patches.  Over a ``launch.mesh.Mesh`` (``rules`` from ``make_rules(...,
    kind="prefill")``), every input and output holds this rank's batch
    rows, ``params`` this rank's blocks by ``param_specs``, and the cache
    the decode step's layout (``transformer.prefill_step``)."""
    @torch.inference_mode()
    def prefill_step(params, tokens, cross_src=None):
        return T.prefill_step(cfg, params, tokens, max_seq=max_seq,
                              cross_src=cross_src, rules=rules, mesh=mesh)
    return prefill_step


def make_decode_step(cfg: T.ModelConfig, *, rules=NO_SHARD, mesh=None,
                     sample: bool = False, temperature: float = 1.0):
    """``decode_step(params, cache, tokens [B, 1], pos, gen=None) ->
    (next tokens int32 [B], logits [B, V] float32, cache)``; the cache is
    updated in place.  Over a mesh (``rules`` of ``kind="decode"``), as
    ``make_prefill_step``.

    Greedy takes the argmax.  ``sample=True`` draws from
    ``softmax(logits / temperature)`` with the ``torch.Generator`` ``gen``;
    it does not follow the stream of the reference's
    ``jax.random.categorical``, so sampled tokens differ between the two
    packages (greedy ones agree).
    """
    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos, gen=None):
        logits, cache = T.decode_step(cfg, params, cache, tokens, pos,
                                      rules=rules, mesh=mesh)
        if sample:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        return next_tok.to(torch.int32), logits, cache
    return decode_step
