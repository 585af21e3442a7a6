"""Serving steps: prefill (prompt -> cache) and decode (one token) (port of
``repro/train/serve_step.py``).  Both run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg: T.ModelConfig, *, max_seq: int | None = None):
    """``prefill_step(params, tokens) -> (logits [B, V] float32, cache)``."""
    @torch.inference_mode()
    def prefill_step(params, tokens):
        return T.prefill_step(cfg, params, tokens, max_seq=max_seq)
    return prefill_step


def make_decode_step(cfg: T.ModelConfig, *, sample: bool = False,
                     temperature: float = 1.0):
    """``decode_step(params, cache, tokens [B, 1], pos, gen=None) ->
    (next tokens int32 [B], logits [B, V] float32, cache)``; the cache is
    updated in place.

    Greedy takes the argmax.  ``sample=True`` draws from
    ``softmax(logits / temperature)`` with the ``torch.Generator`` ``gen``;
    it does not follow the stream of the reference's
    ``jax.random.categorical``, so sampled tokens differ between the two
    packages (greedy ones agree).
    """
    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos, gen=None):
        logits, cache = T.decode_step(cfg, params, cache, tokens, pos)
        if sample:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        return next_tok.to(torch.int32), logits, cache
    return decode_step
