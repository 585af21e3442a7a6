"""The dense-attention transformer: parameters, forward, prefill and decode
(port of ``repro/models/transformer.py`` for the ``attn`` stage kind with a
dense MLP).

A model is a sequence of :class:`Pattern` groups, each ``repeats`` copies
of a stage list (gemma3 = 4×[5 local, 1 global] + [2 local]).  The
parameter tree is the reference's, leaf for leaf: every stage leaf is
stacked ``[repeats, count, ...]``, so ``interop.params_from`` maps the
reference's tree across and the layer loops index ``[r, c]``.  Where the
reference scans over repeats and layers, the port loops in Python.
Decode caches are stacked the same way, ``[repeats, count, B, slen, KV,
hd]`` with ``slen = min(window, max_seq)``.

The functions take the tree; :class:`Transformer` holds the same leaves as
``nn.Parameter``\\ s under the reference's names and calls them.

Not ported yet (``ROADMAP.md`` queue 1 item 5): the MoE FFN, the mamba and
hybrid stages, cross-attention and the encoder (``cross``,
``attn_cross``, ``enc``) with its learned positions.  A configuration
that needs one of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import (ModelConfig, Pattern, StageSpec,
                                       uniform_pattern)

__all__ = [
    "ModelConfig", "Pattern", "StageSpec", "uniform_pattern", "Transformer",
    "init_params", "param_shapes", "param_count", "forward",
    "logits_from_hidden", "init_cache", "prefill_step", "decode_step",
]

_TODO = "is not ported yet (ROADMAP.md queue 1 item 5: {})"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a part of ``cfg`` this port lacks."""
    if cfg.moe_experts:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN " +
                                  _TODO.format("the MoE FFN"))
    if cfg.encoder_layers or cfg.max_position:
        raise NotImplementedError(
            f"{cfg.name}: the encoder with learned positions " +
            _TODO.format("cross-attention and the encoder"))
    for pat in cfg.patterns:
        for st in pat.stages:
            if st.kind in ("mamba", "hybrid"):
                raise NotImplementedError(
                    f"{cfg.name}: stage kind {st.kind!r} " +
                    _TODO.format("mamba and hybrid stages"))
            if st.kind != "attn":
                raise NotImplementedError(
                    f"{cfg.name}: stage kind {st.kind!r} " +
                    _TODO.format("cross-attention and the encoder"))


# ---------------------------------------------------------------------------
# Parameter construction (initialised tensors or meta-device shapes)
# ---------------------------------------------------------------------------

class _Maker:
    """Builds leaves: drawn from ``gen`` (``mode="init"``) or empty on the
    meta device (``mode="shape"``).  ``stack`` prefixes every leaf's shape;
    scales use the unstacked shape, as the reference's do."""

    def __init__(self, cfg: ModelConfig, mode: str, gen=None, device=None,
                 stack: tuple[int, ...] = ()):
        self.cfg, self.mode, self.gen, self.device = cfg, mode, gen, device
        self.stack = stack

    def with_stack(self, *dims: int) -> "_Maker":
        return _Maker(self.cfg, self.mode, self.gen, self.device, dims)

    def __call__(self, shape: tuple[int, ...], scale: float | None = None,
                 fill: float | None = None) -> torch.Tensor:
        """A normal draw times ``scale`` (default ``1/sqrt(fan_in)``), or a
        constant ``fill`` (no draw)."""
        full = self.stack + tuple(shape)
        dtype = self.cfg.dtype
        if self.mode == "shape":
            return torch.empty(full, dtype=dtype, device="meta")
        if fill is not None:
            return torch.full(full, fill, dtype=dtype, device=self.device)
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0] if len(shape) > 1 else 1)
        x = torch.randn(full, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device) * scale
        return x.to(device=self.device, dtype=dtype)


def _norm_params(mk: _Maker, cfg: ModelConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": mk((cfg.d_model,), fill=1.0),
                "bias": mk((cfg.d_model,), fill=0.0)}
    # gemma stores (1 + w) with w zero; the others a scale of ones
    return {"scale": mk((cfg.d_model,),
                        fill=0.0 if cfg.norm_plus_one else 1.0)}


def _attn_params(mk: _Maker, cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": mk((D, H * hd)), "wk": mk((D, KV * hd)),
         "wv": mk((D, KV * hd)), "wo": mk((H * hd, D))}
    if cfg.qkv_bias:
        p["bq"] = mk((H * hd,), fill=0.0)
        p["bk"] = mk((KV * hd,), fill=0.0)
        p["bv"] = mk((KV * hd,), fill=0.0)
    return p


def _mlp_params(mk: _Maker, cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"up": mk((D, Fd)), "down": mk((Fd, D))}
    if cfg.glu:
        p["gate"] = mk((D, Fd))
    return p


def _ffn_params(mk: _Maker, cfg: ModelConfig) -> dict:
    """The per-layer FFN: the dense MLP (the MoE FFN is not ported)."""
    return {"mlp": _mlp_params(mk, cfg)}


def _layer_params(mk: _Maker, cfg: ModelConfig) -> dict:
    """One ``attn`` layer (the only stage kind ported)."""
    p = {"ln1": _norm_params(mk, cfg), "attn": _attn_params(mk, cfg),
         "ln2": _norm_params(mk, cfg)}
    p.update(_ffn_params(mk, cfg))
    return p


def _build_params(cfg: ModelConfig, mode: str, gen=None, device=None) -> dict:
    check_ported(cfg)
    mk = _Maker(cfg, mode, gen, device)
    params: dict = {"embed": mk((cfg.vocab_size, cfg.d_model), scale=1.0),
                    "final_norm": _norm_params(mk, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mk((cfg.d_model, cfg.vocab_size))
    params["blocks"] = [
        [_layer_params(mk.with_stack(pat.repeats, st.count), cfg)
         for st in pat.stages]
        for pat in cfg.patterns]
    return params


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's scales: ``1/sqrt(fan_in)``
    normals, the embedding at scale 1.0, zero biases, norm scales of ones
    (zeros under ``norm_plus_one``).  Drawn in float32 from ``gen`` on its
    own device, then placed on ``device`` in ``cfg.dtype``.  The
    reference's own init folds a salted ``hash(name)`` into its key and
    differs from run to run, so no test compares two inits."""
    return _build_params(cfg, "init", gen, resolve_device(device))


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device (allocates nothing)."""
    return _build_params(cfg, "shape")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    return sum(t.numel() for t in _leaves(param_shapes(cfg)))


def _layer(stage: dict, r: int, c: int) -> dict:
    """Layer ``[r, c]`` of a stacked stage tree (views, no copy)."""
    return {k: _layer(v, r, c) if isinstance(v, dict) else v[r, c]
            for k, v in stage.items()}


# ---------------------------------------------------------------------------
# Forward (prefill-shaped, full sequence)
# ---------------------------------------------------------------------------

def _ffn_apply(lp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.mlp(lp["mlp"], h, activation=cfg.activation, glu=cfg.glu)


def _norm(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.apply_norm(lp, x, kind=cfg.norm, eps=cfg.norm_eps,
                        plus_one=cfg.norm_plus_one)


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
                rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)


def _layer_fwd(cfg: ModelConfig, spec: StageSpec, lp: dict, x: torch.Tensor,
               *, positions: torch.Tensor) -> torch.Tensor:
    h = _norm(lp["ln1"], x, cfg)
    x = x + L.self_attention(lp["attn"], h, causal=True, window=spec.window,
                             positions=positions, **_attn_kwargs(cfg))
    h = _norm(lp["ln2"], x, cfg)
    return x + _ffn_apply(lp, h, cfg)


def _layers(patterns):
    """(spec, pattern, stage, repeat, layer) of every layer in the
    reference's scan order: pattern, repeat, stage, layer."""
    for pi, pat in enumerate(patterns):
        for r in range(pat.repeats):
            for j, spec in enumerate(pat.stages):
                for c in range(spec.count):
                    yield spec, pi, j, r, c


def _run_patterns(cfg: ModelConfig, patterns, blocks, x: torch.Tensor, *,
                  positions: torch.Tensor) -> torch.Tensor:
    for spec, pi, j, r, c in _layers(patterns):
        x = _layer_fwd(cfg, spec, _layer(blocks[pi][j], r, c), x,
                       positions=positions)
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor
            ) -> torch.Tensor:
    """Full-sequence forward -> final hidden states [B, S, D]."""
    check_ported(cfg)
    S = tokens.shape[1]
    x = L.embed(params["embed"], tokens, scale=cfg.embed_scale)
    positions = torch.arange(S, device=x.device)
    x = _run_patterns(cfg, cfg.patterns, params["blocks"], x,
                      positions=positions)
    return _norm(params["final_norm"], x, cfg)


def logits_from_hidden(cfg: ModelConfig, params: dict, x: torch.Tensor
                       ) -> torch.Tensor:
    return L.lm_logits(params, x, tied=cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _cache_stage(cfg: ModelConfig, spec: StageSpec, stack: tuple[int, int],
                 *, batch: int, max_seq: int, device) -> dict:
    slen = min(spec.window, max_seq) if spec.window else max_seq
    shape = stack + (batch, slen, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list:
    """Zero KV caches: a list of patterns of stages of ``{"k", "v"}``."""
    check_ported(cfg)
    device = resolve_device(device)
    return [[_cache_stage(cfg, st, (pat.repeats, st.count), batch=batch,
                          max_seq=max_seq, device=device)
             for st in pat.stages] for pat in cfg.patterns]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _layer_decode(cfg: ModelConfig, spec: StageSpec, lp: dict, cache: dict,
                  x: torch.Tensor, *, pos: int) -> torch.Tensor:
    """One layer of one-token decode; ``cache`` holds this layer's K/V
    views, updated in place."""
    h = _norm(lp["ln1"], x, cfg)
    a, _, _ = L.decode_self_attention(lp["attn"], h, cache["k"], cache["v"],
                                      pos, window=spec.window,
                                      **_attn_kwargs(cfg))
    x = x + a
    h = _norm(lp["ln2"], x, cfg)
    return x + _ffn_apply(lp, h, cfg)


def decode_step(cfg: ModelConfig, params: dict, cache: list,
                tokens: torch.Tensor, pos: int):
    """One-token decode.  tokens: [B, 1]; ``pos`` an int (aligned batch).

    Returns (logits [B, V] float32, cache).  The cache is updated in place
    (the reference returns a new one) and returned.
    """
    check_ported(cfg)
    pos = int(pos)
    x = L.embed(params["embed"], tokens, scale=cfg.embed_scale)
    blocks = params["blocks"]
    for spec, pi, j, r, c in _layers(cfg.patterns):
        cj = cache[pi][j]
        x = _layer_decode(cfg, spec, _layer(blocks[pi][j], r, c),
                          {"k": cj["k"][r, c], "v": cj["v"][r, c]}, x,
                          pos=pos)
    x = _norm(params["final_norm"], x, cfg)
    return logits_from_hidden(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Prefill: full forward that also fills the decode caches
# ---------------------------------------------------------------------------

PREFILL_CHUNK_THRESHOLD = 8192     # the forward's is 2048 (layers.py)


def _fill_kv_cache(k: torch.Tensor, window: int, S: int, max_seq: int
                   ) -> torch.Tensor:
    """Place prefill K/V rows at the slots ``decode_step`` expects.

    Global layers: slots 0..S-1 of a max_seq cache.  Windowed layers: ring
    buffer of size W=min(window, max_seq); position p lives at slot p % W.
    """
    if not window:
        if max_seq > S:
            k = F.pad(k, (0, 0, 0, 0, 0, max_seq - S))
        return k
    W = min(window, max_seq)
    if S < W:
        return F.pad(k, (0, 0, 0, 0, 0, W - S))
    kw = k[:, S - W:]
    return torch.roll(kw, S % W, dims=1)  # position S-W+j -> slot (S-W+j)%W


def _layer_prefill(cfg: ModelConfig, spec: StageSpec, lp: dict,
                   x: torch.Tensor, *, positions: torch.Tensor, max_seq: int):
    """Like ``_layer_fwd`` but also returns this layer's (k, v) cache rows;
    chunked attention only above ``PREFILL_CHUNK_THRESHOLD`` tokens."""
    B, S, _ = x.shape
    h = _norm(lp["ln1"], x, cfg)
    q, k, v = L._qkv(lp["attn"], h, n_heads=cfg.num_heads,
                     n_kv=cfg.num_kv_heads, head_dim=cfg.hd,
                     qkv_bias=cfg.qkv_bias)
    if cfg.use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    kf = L._repeat_kv(k, cfg.num_heads)
    vf = L._repeat_kv(v, cfg.num_heads)
    if S > PREFILL_CHUNK_THRESHOLD:
        o = L.chunked_attention(q, kf, vf, causal=True, window=spec.window)
    else:
        o = L.attention_core(q, kf, vf, causal=True, window=spec.window)
    x = x + o.reshape(B, S, -1) @ lp["attn"]["wo"]
    ck = _fill_kv_cache(k.to(cfg.dtype), spec.window, S, max_seq)
    cv = _fill_kv_cache(v.to(cfg.dtype), spec.window, S, max_seq)
    h = _norm(lp["ln2"], x, cfg)
    return x + _ffn_apply(lp, h, cfg), ck, cv


def prefill_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 max_seq: int | None = None):
    """Forward over the prompt; returns (last-token logits [B, V] float32,
    filled cache).

    ``max_seq`` sizes the cache (>= prompt length; default the prompt
    length).  Windowed layers fill their ring buffers at ring-consistent
    slots (slot = position % window), so ``decode_step`` continues
    seamlessly.
    """
    check_ported(cfg)
    B, S = tokens.shape
    max_seq = max_seq or S
    x = L.embed(params["embed"], tokens, scale=cfg.embed_scale)
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    blocks = params["blocks"]
    for spec, pi, j, r, c in _layers(cfg.patterns):
        x, ck, cv = _layer_prefill(cfg, spec, _layer(blocks[pi][j], r, c), x,
                                   positions=positions, max_seq=max_seq)
        cache[pi][j]["k"][r, c] = ck
        cache[pi][j]["v"][r, c] = cv
    x = _norm(params["final_norm"], x, cfg)
    return logits_from_hidden(cfg, params, x[:, -1:])[:, 0], cache


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """A parameter tree's dicts as modules, its leaves as parameters under
    the reference's names (``blocks.0.0.attn.wq``, ...)."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))
            elif isinstance(v, dict):
                self.add_module(k, _ParamTree(v))
            else:                                 # blocks: patterns × stages
                self.add_module(k, nn.ModuleList(
                    nn.ModuleList(_ParamTree(s) for s in pat) for pat in v))

    def tree(self) -> dict:
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            if isinstance(v, _ParamTree):
                out[k] = v.tree()
            elif isinstance(v, nn.ModuleList):
                out[k] = [[s.tree() for s in pat] for pat in v]
            else:
                out[k] = v
        return out


class Transformer(nn.Module):
    """The model as an ``nn.Module``: the tree's leaves as parameters;
    ``forward``, ``prefill`` and ``decode`` call the plain functions."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.params = _ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return logits_from_hidden(self.cfg, self.tree(), hidden)

    def prefill(self, tokens: torch.Tensor, max_seq: int | None = None):
        return prefill_step(self.cfg, self.tree(), tokens, max_seq=max_seq)

    def decode(self, cache: list, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.tree(), cache, tokens, pos)
