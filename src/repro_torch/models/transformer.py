"""The transformer / SSM model of every assigned architecture: parameters,
forward, the training loss, prefill and decode (port of
``repro/models/transformer.py``).

A model is a sequence of :class:`Pattern` groups, each ``repeats`` copies
of a stage list (gemma3 = 4×[5 local, 1 global] + [2 local]).  The stage
kinds: ``attn``; ``attn_cross`` (self- then cross-attention, whisper's
decoder); ``cross`` (tanh-gated cross-attention, llama-vision's image
layers); ``mamba``; ``hybrid`` (attention and Mamba heads side by side,
their outputs normalised and averaged, hymba); ``enc`` (whisper's
bidirectional encoder).  The FFN is a dense MLP, the MoE block, or the
MoE beside a dense MLP (arctic).

The parameter tree is the reference's, leaf for leaf: every stage leaf is
stacked ``[repeats, count, ...]``, so ``interop.params_from`` maps the
reference's tree across.  Where the reference scans over repeats and
layers, the port loops in Python: prefill and decode index each layer
``[r, c]``; ``forward`` (the training path) unbinds each stack once, and
under autograd recomputes each layer in the backward (``remat``), as the
reference's ``nothing_saveable`` checkpoint does.  ``lm_loss`` is the
next-token cross-entropy in chunks of positions, each chunk's logits
recomputed in the backward.  Decode
caches are stacked the same way: ``k`` / ``v`` ``[repeats, count, B,
slen, KV, hd]`` with ``slen = min(window, max_seq)``, ``xk`` / ``xv``
``[..., B, cross_len, KV, hd]``, ``conv`` ``[..., B, K-1, d_inner]`` and
``ssm`` ``[..., B, d_inner, N]`` in float32.

Sharding: ``param_specs`` and ``cache_specs`` give the reference's
partition specs (``layers.P``), ``param_shapes`` and ``cache_shapes`` the
same trees on the meta device; the dry-run's memory model reads them.
``forward``, ``lm_loss``, ``prefill_step`` and ``decode_step`` take the
reference's ``rules`` and a ``launch.mesh.Mesh``: over a mesh the tree
holds this rank's block of every leaf by ``param_specs`` and the layers
run their ``layers.*_mesh`` forms (see ``layers``): FSDP gathers on use,
tensor-parallel attention, MLP, Mamba, embedding and logits, the residual
sequence-parallel under ``rules.act_seq`` (``forward`` then returns this
rank's block of the sequence), a vocabulary-parallel loss, and decode
caches split over ``rules.seq`` (``ShardingRules.cache_seq``).

The functions take the tree; :class:`Transformer` holds the same leaves as
``nn.Parameter``\\ s under the reference's names and calls them.
"""
from __future__ import annotations

import functools
import itertools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch import trips
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import NO_SHARD, P, ShardingRules
from repro_torch.models.config import (ModelConfig, Pattern, StageSpec,
                                       uniform_pattern)
from repro_torch.tree import tree_leaves

__all__ = [
    "ModelConfig", "Pattern", "StageSpec", "uniform_pattern", "Transformer",
    "FLOAT32_LEAVES", "MESH_AXIS_SIZES", "init_params", "param_shapes",
    "param_specs", "param_count", "active_param_count", "encode", "forward",
    "logits_from_hidden", "lm_loss", "init_cache", "cache_shapes",
    "cache_specs", "prefill_step", "decode_step",
]

# Leaves the reference keeps in float32 in a model of any dtype: the SSM's
# A_log, D and dt_bias, and the cross layers' tanh gates.
FLOAT32_LEAVES = frozenset({"A_log", "D", "dt_bias", "gate_attn",
                            "gate_mlp"})


# ---------------------------------------------------------------------------
# Parameter construction (initialised tensors, meta-device shapes or specs)
# ---------------------------------------------------------------------------

# Mesh-axis sizes the parameter specs assume (the production meshes'):
# a spec keeps an axis only where it divides the dim, whatever the real
# mesh is (whisper's 51,865-row embedding stays whole), as the reference's
# in_shardings require.
MESH_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _fit_spec(shape, spec) -> tuple:
    """``spec`` with every axis entry that does not divide its dim (by
    ``MESH_AXIS_SIZES``) made None."""
    out = []
    for dim, ax in zip(shape, spec):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        size = math.prod(MESH_AXIS_SIZES.get(a, 1) for a in axes)
        out.append(ax if size and dim % size == 0 else None)
    return tuple(out)


class _Maker:
    """Builds leaves: drawn from ``gen`` (``mode="init"``), empty on the
    meta device (``mode="shape"``) or the leaf's partition spec
    (``mode="spec"``: ``spec`` fitted by ``_fit_spec``, the stack dims
    whole).  ``stack`` prefixes every leaf's shape; scales use the
    unstacked shape, as the reference's do."""

    def __init__(self, cfg: ModelConfig, mode: str, gen=None, device=None,
                 stack: tuple[int, ...] = ()):
        self.cfg, self.mode, self.gen, self.device = cfg, mode, gen, device
        self.stack = stack

    def with_stack(self, *dims: int) -> "_Maker":
        return _Maker(self.cfg, self.mode, self.gen, self.device, dims)

    def __call__(self, shape: tuple[int, ...], spec: tuple,
                 scale: float | None = None, fill: float | None = None,
                 dtype=None):
        """A normal draw times ``scale`` (default ``1/sqrt(shape[0])``), or
        a constant ``fill`` (no draw), in ``dtype`` (default the model's).

        The draw is made in float32 one stacked slice at a time on the
        generator's device, so the float32 transient is one layer's leaf
        (moonshot's stacked expert leaf is 8.86e9 values, 35.4 GB in
        float32)."""
        if self.mode == "spec":
            return P(*(None,) * len(self.stack), *_fit_spec(shape, spec))
        full = self.stack + tuple(shape)
        dtype = dtype or self.cfg.dtype
        if self.mode == "shape":
            return torch.empty(full, dtype=dtype, device="meta")
        if fill is not None:
            return torch.full(full, fill, dtype=dtype, device=self.device)
        if scale is None:
            scale = 1.0 / math.sqrt(shape[0] if len(shape) > 1 else 1)
        out = torch.empty(full, dtype=dtype, device=self.device)
        for idx in itertools.product(*map(range, self.stack)):
            out[idx] = torch.randn(shape, generator=self.gen,
                                   dtype=torch.float32,
                                   device=self.gen.device).mul_(scale)
        return out


def _norm_params(mk: _Maker, cfg: ModelConfig) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": mk((cfg.d_model,), (None,), fill=1.0),
                "bias": mk((cfg.d_model,), (None,), fill=0.0)}
    # gemma stores (1 + w) with w zero; the others a scale of ones
    return {"scale": mk((cfg.d_model,), (None,),
                        fill=0.0 if cfg.norm_plus_one else 1.0)}


def _attn_params(mk: _Maker, cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    t, f = "model", "data"
    p = {"wq": mk((D, H * hd), (f, t)), "wk": mk((D, KV * hd), (f, t)),
         "wv": mk((D, KV * hd), (f, t)), "wo": mk((H * hd, D), (t, f))}
    if cfg.qkv_bias:
        p["bq"] = mk((H * hd,), (t,), fill=0.0)
        p["bk"] = mk((KV * hd,), (t,), fill=0.0)
        p["bv"] = mk((KV * hd,), (t,), fill=0.0)
    return p


def _mlp_params(mk: _Maker, cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"up": mk((D, Fd), ("data", "model")),
         "down": mk((Fd, D), ("model", "data"))}
    if cfg.glu:
        p["gate"] = mk((D, Fd), ("data", "model"))
    return p


def _moe_params(mk: _Maker, cfg: ModelConfig) -> dict:
    """The router and the experts' stacked weights ``[E, ...]``; their
    draw scale is ``1/sqrt(E)``, the reference's ``shape[0]`` rule."""
    D, E, Fd = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    p = {"router": mk((D, E), (None, None)),
         "up": mk((E, D, Fd), ("model", "data", None)),
         "down": mk((E, Fd, D), ("model", "data", None))}
    if cfg.glu:
        p["gate"] = mk((E, D, Fd), ("model", "data", None))
    return p


def _mamba_params(mk: _Maker, cfg: ModelConfig) -> dict:
    """The Mamba-1 mixer.  ``A_log`` = log(1..N) (so A = -exp(A_log) is
    negative and spread), ``D`` = 1 and ``dt_bias`` = -4, all float32."""
    D, di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.conv_kernel)
    f32, t = torch.float32, "model"
    p = {"in_proj": mk((D, 2 * di), ("data", t)),
         "conv_w": mk((K, di), (None, t)),
         "conv_b": mk((di,), (t,), fill=0.0),
         "x_proj": mk((di, R + 2 * N), (t, None)),
         "dt_proj": mk((R, di), (None, t)),
         "dt_bias": mk((di,), (t,), fill=-4.0, dtype=f32),
         "A_log": mk((di, N), (t, None), fill=0.0, dtype=f32),
         "D": mk((di,), (t,), fill=1.0, dtype=f32),
         "out_proj": mk((di, D), (t, "data"))}
    if mk.mode == "init":
        p["A_log"].copy_(torch.log(torch.arange(
            1, N + 1, dtype=f32, device=p["A_log"].device)))
    return p


def _ffn_params(mk: _Maker, cfg: ModelConfig) -> dict:
    """The per-layer FFN: dense MLP, MoE, or MoE + dense residual (arctic)."""
    if cfg.moe_experts:
        p = {"moe": _moe_params(mk, cfg)}
        if cfg.moe_dense_residual:
            p["mlp"] = _mlp_params(mk, cfg)
        return p
    return {"mlp": _mlp_params(mk, cfg)}


def _layer_params(mk: _Maker, cfg: ModelConfig, kind: str) -> dict:
    p = {"ln1": _norm_params(mk, cfg)}
    if kind in ("attn", "enc"):
        p["attn"] = _attn_params(mk, cfg)
    elif kind == "attn_cross":
        p["attn"] = _attn_params(mk, cfg)
        p["lnx"] = _norm_params(mk, cfg)
        p["xattn"] = _attn_params(mk, cfg)
    elif kind == "cross":
        p["xattn"] = _attn_params(mk, cfg)
        p["gate_attn"] = mk((), (), fill=0.0, dtype=torch.float32)
        p["gate_mlp"] = mk((), (), fill=0.0, dtype=torch.float32)
    elif kind == "mamba":
        p["mixer"] = _mamba_params(mk, cfg)
        return p
    elif kind == "hybrid":
        p["attn"] = _attn_params(mk, cfg)
        p["mixer"] = _mamba_params(mk, cfg)
        p["attn_norm"] = mk((cfg.d_model,), (None,), fill=1.0)
        p["ssm_norm"] = mk((cfg.d_model,), (None,), fill=1.0)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    p["ln2"] = _norm_params(mk, cfg)
    p.update(_ffn_params(mk, cfg))
    return p


def _build_params(cfg: ModelConfig, mode: str, gen=None, device=None) -> dict:
    mk = _Maker(cfg, mode, gen, device)
    params: dict = {"embed": mk((cfg.vocab_size, cfg.d_model),
                                ("model", None), scale=1.0),
                    "final_norm": _norm_params(mk, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mk((cfg.d_model, cfg.vocab_size),
                               ("data", "model"))
    if cfg.max_position:
        params["pos_embed"] = mk((cfg.max_position, cfg.d_model),
                                 (None, None), scale=0.02)
    params["blocks"] = [
        [_layer_params(mk.with_stack(pat.repeats, st.count), cfg, st.kind)
         for st in pat.stages]
        for pat in cfg.patterns]
    if cfg.encoder_layers:
        params["encoder"] = {
            "pos_embed": mk((cfg.cross_seq, cfg.d_model), (None, None),
                            scale=0.02),
            "blocks": [[_layer_params(mk.with_stack(1, cfg.encoder_layers),
                                      cfg, "enc")]],
            "final_norm": _norm_params(mk, cfg)}
    return params


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's scales: ``1/sqrt(shape[0])``
    normals, the embedding at scale 1.0 and learned positions at 0.02,
    zero biases, norm scales of ones (zeros under ``norm_plus_one``), the
    SSM's constants and zero cross gates (``FLOAT32_LEAVES`` in float32).
    Drawn in float32 from ``gen`` on its own device, one stacked slice at a
    time, and placed on ``device`` in ``cfg.dtype``.  The reference's own
    init folds a salted ``hash(name)`` into its key and differs from run
    to run, so no test compares two inits."""
    return _build_params(cfg, "init", gen, resolve_device(device))


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device (allocates nothing)."""
    return _build_params(cfg, "shape")


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's partition specs (``layers.P`` leaves): the
    reference's, each axis kept only where ``MESH_AXIS_SIZES`` divides
    its dim, the stack dims whole."""
    return _build_params(cfg, "spec")


def param_count(cfg: ModelConfig) -> int:
    return sum(t.numel() for t in tree_leaves(param_shapes(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of moe_experts)."""
    total = param_count(cfg)
    if not cfg.moe_experts:
        return total
    experts = sum(stage["moe"][nm].numel()
                  for pat in param_shapes(cfg)["blocks"] for stage in pat
                  if "moe" in stage for nm in ("up", "down", "gate")
                  if nm in stage["moe"])
    return int(total - experts + experts * cfg.moe_top_k / cfg.moe_experts)


def _layer(stage: dict, r: int, c: int) -> dict:
    """Layer ``[r, c]`` of a stacked stage tree (views, no copy)."""
    return {k: _layer(v, r, c) if isinstance(v, dict) else v[r, c]
            for k, v in stage.items()}


def _layer_specs(stage: dict) -> dict:
    """A stacked stage's specs with the two stack dims dropped: any layer
    ``[r, c]``'s."""
    return {k: _layer_specs(v) if isinstance(v, dict) else P(*v[2:])
            for k, v in stage.items()}


# ---------------------------------------------------------------------------
# Forward (prefill-shaped, full sequence)
# ---------------------------------------------------------------------------

def _mlp(cfg: ModelConfig, lp: dict, ls: dict | None, h: torch.Tensor,
         on: L.OnMesh | None) -> torch.Tensor:
    if on is None:
        return L.mlp(lp["mlp"], h, activation=cfg.activation, glu=cfg.glu)
    return L.mlp_mesh(lp["mlp"], ls["mlp"], h, on, activation=cfg.activation,
                      glu=cfg.glu)


def _ffn(cfg: ModelConfig, lp: dict, ls: dict | None, h: torch.Tensor,
         on: L.OnMesh | None) -> torch.Tensor:
    """The FFN: the MoE (with arctic's dense residual beside it) or the
    MLP.  Here and below ``on`` is the mesh (None: no mesh) and ``ls``
    the layer's specs, which split ``lp``'s leaves over it."""
    if not cfg.moe_experts:
        return _mlp(cfg, lp, ls, h, on)
    out = L.moe_block(lp["moe"], h, n_experts=cfg.moe_experts,
                      top_k=cfg.moe_top_k,
                      capacity_factor=cfg.capacity_factor,
                      activation=cfg.activation, glu=cfg.glu,
                      mesh=None if on is None else on.mesh,
                      rules=NO_SHARD if on is None else on.rules)
    if cfg.moe_dense_residual:
        out = out + _mlp(cfg, lp, ls, h, on)
    return out


def _norm(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.apply_norm(lp, x, kind=cfg.norm, eps=cfg.norm_eps,
                        plus_one=cfg.norm_plus_one)


def _gnorm(on: L.OnMesh | None, lp: dict, x: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """The norm, then (sequence parallelism) gathered along the sequence,
    as the reference's ``_gnorm`` pins it."""
    h = _norm(lp, x, cfg)
    return h if on is None else L.seq_gather(on, h)


def _attn_kwargs(cfg: ModelConfig, kind: str = "attn") -> dict:
    """Self-attention's arguments; the encoder uses no rope."""
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
                rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope and kind != "enc")


def _cross_kwargs(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.hd, qkv_bias=cfg.qkv_bias)


def _cross_kv(cfg: ModelConfig, lp: dict, ls: dict | None, src: torch.Tensor,
              on: L.OnMesh | None):
    """A cross layer's (xk, xv) of the source, as prefill caches them."""
    kw = dict(n_kv=cfg.num_kv_heads, head_dim=cfg.hd, qkv_bias=cfg.qkv_bias)
    if on is None:
        k, v = L.project_cross_kv(lp["xattn"], src, **kw)
    else:
        k, v = L.project_cross_kv_mesh(lp["xattn"], ls["xattn"], src, on, **kw)
    return k.to(cfg.dtype), v.to(cfg.dtype)


def _cross_attn(cfg: ModelConfig, lp: dict, ls: dict | None, h: torch.Tensor,
                kv, on: L.OnMesh | None) -> torch.Tensor:
    if on is None:
        return L.cross_attention(lp["xattn"], h, kv, **_cross_kwargs(cfg))
    return L.cross_attention_mesh(lp["xattn"], ls["xattn"], h, kv, on,
                                  **_cross_kwargs(cfg))


def _gated_cross(cfg: ModelConfig, lp: dict, ls: dict | None,
                 x: torch.Tensor, kv, on: L.OnMesh | None) -> torch.Tensor:
    """A ``cross`` layer: cross-attention and the FFN, each scaled by the
    tanh of its float32 gate (zero at init: the layer then adds nothing).
    ``kv`` is the source [B, Se, D] or its (xk, xv)."""
    h = _gnorm(on, lp["ln1"], x, cfg)
    x = x + torch.tanh(lp["gate_attn"]).to(x.dtype) * \
        _cross_attn(cfg, lp, ls, h, kv, on)
    h = _gnorm(on, lp["ln2"], x, cfg)
    return x + torch.tanh(lp["gate_mlp"]).to(x.dtype) * \
        _ffn(cfg, lp, ls, h, on)


def _fuse(cfg: ModelConfig, lp: dict, a: torch.Tensor, m: torch.Tensor
          ) -> torch.Tensor:
    """A ``hybrid`` layer's attention and SSM outputs, each RMS-normalised
    by its own scale, averaged."""
    return 0.5 * (L.rms_norm(lp["attn_norm"], a, cfg.norm_eps) +
                  L.rms_norm(lp["ssm_norm"], m, cfg.norm_eps))


def _cross_and_ffn(cfg: ModelConfig, kind: str, lp: dict, ls: dict | None,
                   x: torch.Tensor, kv, on: L.OnMesh | None) -> torch.Tensor:
    """The tail of an attention layer: ``attn_cross``'s cross-attention
    over ``kv``, then the FFN."""
    if kind == "attn_cross":
        h = _gnorm(on, lp["lnx"], x, cfg)
        x = x + _cross_attn(cfg, lp, ls, h, kv, on)
    h = _gnorm(on, lp["ln2"], x, cfg)
    return x + _ffn(cfg, lp, ls, h, on)


def _layer_fwd(cfg: ModelConfig, spec: StageSpec, lp: dict, x: torch.Tensor,
               *, positions: torch.Tensor, cross_src) -> torch.Tensor:
    kind = spec.kind
    if kind == "cross":
        return _gated_cross(cfg, lp, None, x, cross_src, None)
    h = _norm(lp["ln1"], x, cfg)
    if kind == "mamba":
        return x + L.mamba_mixer(lp["mixer"], h, d_state=cfg.ssm_state)
    if kind not in ("attn", "enc", "attn_cross", "hybrid"):
        raise ValueError(f"unknown layer kind {kind}")
    a = L.self_attention(lp["attn"], h, causal=kind != "enc",
                         window=spec.window, positions=positions,
                         **_attn_kwargs(cfg, kind))
    if kind == "hybrid":
        m = L.mamba_mixer(lp["mixer"], h, d_state=cfg.ssm_state)
        x = x + _fuse(cfg, lp, a, m)
    else:
        x = x + a
    return _cross_and_ffn(cfg, kind, lp, None, x, cross_src, None)


def _layer_mesh(cfg: ModelConfig, spec: StageSpec, lp: dict, ls: dict,
                x: torch.Tensor, *, positions: torch.Tensor, cross_src,
                on: L.OnMesh, threshold: int, cache: dict | None = None,
                max_seq: int = 0) -> torch.Tensor:
    """One layer over a mesh (train / prefill): ``lp`` this rank's blocks,
    ``ls`` their specs, ``x`` the residual layout.  ``cache``, where given
    (prefill), receives the layer's cache leaves: K / V whole along the
    sequence, the Mamba states of this rank's channels."""
    kind = spec.kind
    if kind == "cross":
        kv = cross_src
        if cache is not None:
            cache["xk"], cache["xv"] = kv = _cross_kv(cfg, lp, ls, cross_src,
                                                      on)
        return _gated_cross(cfg, lp, ls, x, kv, on)
    if kind not in ("attn", "enc", "attn_cross", "mamba", "hybrid"):
        raise ValueError(f"unknown layer kind {kind}")
    seq_local = (on.sp and on.rules.seq_parallel_attn and
                 kind in ("attn", "enc", "attn_cross"))
    h = _norm(lp["ln1"], x, cfg)
    if not seq_local:
        h = L.seq_gather(on, h)
    if kind != "mamba":          # attention first, as _layer_fwd's order
        a, k, v = L.attention_mesh(
            lp["attn"], ls["attn"], h, on, causal=kind != "enc",
            window=spec.window, positions=positions,
            chunk_threshold=threshold, seq_local=seq_local,
            **_attn_kwargs(cfg, kind))
        if cache is not None:
            S = k.shape[1]
            cache["k"] = _fill_kv_cache(k.to(cfg.dtype), spec.window, S,
                                        max_seq)
            cache["v"] = _fill_kv_cache(v.to(cfg.dtype), spec.window, S,
                                        max_seq)
    if kind in ("mamba", "hybrid"):
        m, xc, h_last = L.mamba_mixer_mesh(lp["mixer"], ls["mixer"], h, on,
                                           d_state=cfg.ssm_state,
                                           d_inner=cfg.d_inner)
        if cache is not None:
            K1 = cfg.conv_kernel - 1
            cache["conv"] = F.pad(xc, (0, 0, K1, 0))[:, -K1:].to(cfg.dtype)
            cache["ssm"] = h_last
        if kind == "mamba":
            return x + m
    x = x + (_fuse(cfg, lp, a, m) if kind == "hybrid" else a)
    kv = cross_src
    if kind == "attn_cross" and cache is not None:
        cache["xk"], cache["xv"] = kv = _cross_kv(cfg, lp, ls, cross_src, on)
    return _cross_and_ffn(cfg, kind, lp, ls, x, kv, on)


def _layers(patterns):
    """(spec, pattern, stage, repeat, layer) of every layer in the
    reference's scan order: pattern, repeat, stage, layer."""
    for pi, pat in enumerate(patterns):
        for r in range(pat.repeats):
            for j, spec in enumerate(pat.stages):
                for c in range(spec.count):
                    yield spec, pi, j, r, c


def _unstack(stage: dict, repeats: int, count: int) -> list:
    """Every layer ``[r][c]`` of a stacked stage tree, from one
    ``torch.unbind`` of each leaf over its two stack dims flattened
    (views).  Under autograd the unbind's backward stacks the layers'
    gradients in one op, where indexing each layer would add a zero tensor
    the size of the whole stack per layer."""
    flat = _flat_layers(stage, repeats * count)
    return [flat[r * count:(r + 1) * count] for r in range(repeats)]


def _flat_layers(stage: dict, n: int) -> list:
    cols = {k: _flat_layers(v, n) if isinstance(v, dict) else
            v.flatten(0, 1).unbind(0) for k, v in stage.items()}
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def _stage_key(layer) -> tuple:
    """The layers of one stage do alike (``trips.each``)."""
    return layer[1:3]


def _run_patterns(cfg: ModelConfig, patterns, blocks, x: torch.Tensor, *,
                  positions: torch.Tensor, cross_src=None,
                  rules: ShardingRules = NO_SHARD, mesh=None,
                  remat: bool = True, specs=None) -> torch.Tensor:
    """The layers in scan order.  Under autograd with ``remat``, each
    layer is recomputed in the backward from its input (the reference's
    ``nothing_saveable`` checkpoint), so only the layers' inputs are kept
    between forward and backward (over a mesh the recompute gathers its
    leaves again).  Over a mesh ``specs`` are ``blocks``' specs."""
    remat = remat and torch.is_grad_enabled()
    layers = [[_unstack(stage, pat.repeats, spec.count)
               for stage, spec in zip(blocks[pi], pat.stages)]
              for pi, pat in enumerate(patterns)]
    fn, kw = _layer_fwd, {}
    if mesh is not None:
        fn, kw = _layer_mesh, dict(on=L.OnMesh(mesh, rules,
                                               seq=positions.shape[0]),
                                   threshold=L.CHUNK_THRESHOLD)
    # a source with a gradient gathers one from every layer: those layers
    # are not alike for a step analysis (the sums of their parts)
    alike = cross_src is None or not cross_src.requires_grad
    for (spec, pi, j, r, c), n in trips.each(
            _layers(patterns), _stage_key if alike else lambda layer: layer):
        args = (cfg, spec, layers[pi][j][r][c])
        if mesh is not None:
            args += (_layer_specs(specs[pi][j]),)
        x = trips.enter(x, n)
        if remat:
            x = ckpt.checkpoint(fn, *args, x, positions=positions,
                                cross_src=cross_src, **kw,
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x = fn(*args, x, positions=positions, cross_src=cross_src, **kw)
        x = trips.leave(x, n)
    return x


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           rules: ShardingRules = NO_SHARD, mesh=None) -> torch.Tensor:
    """Whisper's encoder over precomputed front-end frames [B, Se, D]:
    learned positions, ``encoder_layers`` bidirectional layers without
    rope, the final norm."""
    enc = params["encoder"]
    S = frames.shape[1]
    x = frames.to(cfg.dtype) + enc["pos_embed"][None, :S]
    patterns = (Pattern(1, (StageSpec("enc", cfg.encoder_layers, 0),)),)
    specs = None
    if mesh is not None:
        specs = param_specs(cfg)["encoder"]["blocks"]
        x = L.seq_own(L.OnMesh(mesh, rules), x)
    x = _run_patterns(cfg, patterns, enc["blocks"], x,
                      positions=torch.arange(S, device=x.device),
                      rules=rules, mesh=mesh, specs=specs)
    x = _norm(enc["final_norm"], x, cfg)
    if mesh is not None:         # the decoder's cross layers read it whole
        x = L.seq_gather(L.OnMesh(mesh, rules, seq=S), x)
    return x


def _cross_source(cfg: ModelConfig, params: dict, cross_src, *,
                  rules: ShardingRules, mesh):
    """What the cross layers attend to: the encoder's output over the
    frames (whisper) or the patches as given (llama-vision); None for a
    model without cross layers."""
    if not cfg.cross_seq:
        return None
    if cross_src is None:
        raise ValueError(f"{cfg.name} has cross-attention layers: pass "
                         f"cross_src [B, {cfg.cross_seq}, {cfg.d_model}]")
    if cfg.encoder_layers:
        return encode(cfg, params, cross_src, rules=rules, mesh=mesh)
    return cross_src


def _embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  on: L.OnMesh | None) -> torch.Tensor:
    """Token embeddings; over a mesh (``on``) in the residual layout."""
    if on is None:
        return L.embed(params["embed"], tokens, scale=cfg.embed_scale)
    return L.embed_mesh(params["embed"], param_specs(cfg)["embed"], tokens,
                        on, scale=cfg.embed_scale, vocab=cfg.vocab_size)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           on: L.OnMesh | None = None) -> torch.Tensor:
    """Token embeddings plus learned positions 0..S-1 where the model has
    them; over a mesh (``on``) in the residual layout."""
    x = _embed_tokens(cfg, params, tokens, on)
    if cfg.max_position:
        pe = params["pos_embed"][None, :tokens.shape[1]]
        x = x + (pe if on is None else L.seq_own(on, pe))
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            cross_src: torch.Tensor | None = None,
            rules: ShardingRules = NO_SHARD, mesh=None,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward -> final hidden states [B, S, D].
    ``cross_src``: whisper's frames or llama-vision's patches [B, Se, D].
    ``rules`` / ``mesh``: tokens and the source hold this rank's batch
    rows, the tree this rank's blocks; under sequence parallelism the
    result is this rank's block of the sequence.  ``remat``: under
    autograd, recompute each decoder layer in the backward (the encoder's
    always are, as in the reference)."""
    on = None if mesh is None else L.OnMesh(mesh, rules)
    x = _embed(cfg, params, tokens, on)
    positions = torch.arange(tokens.shape[1], device=x.device)
    cross_src = _cross_source(cfg, params, cross_src, rules=rules,
                              mesh=mesh)
    x = _run_patterns(cfg, cfg.patterns, params["blocks"], x,
                      positions=positions, cross_src=cross_src, rules=rules,
                      mesh=mesh, remat=remat,
                      specs=None if on is None else
                      param_specs(cfg)["blocks"])
    return _norm(params["final_norm"], x, cfg)


def logits_from_hidden(cfg: ModelConfig, params: dict, x: torch.Tensor
                       ) -> torch.Tensor:
    return L.lm_logits(params, x, tied=cfg.tie_embeddings)


def _logits(cfg: ModelConfig, params: dict, x: torch.Tensor,
            on: L.OnMesh | None) -> torch.Tensor:
    """Float32 logits of ``x`` (alike on the tensor group over a mesh:
    each rank's vocabulary columns, gathered whole)."""
    if on is None:
        return logits_from_hidden(cfg, params, x)
    return L.lm_logits_mesh(params, param_specs(cfg), x, on,
                            tied=cfg.tie_embeddings, vocab=cfg.vocab_size)


def _chunk_loss(hb: torch.Tensor, tb: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    """The summed cross-entropy of one chunk: float32 logits of the
    product in the activation dtype, ``logsumexp`` minus the target logit
    (a gather, equal to the reference's one-hot contraction)."""
    logits = (hb @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tb[..., None])[..., 0]
    return torch.sum(lse - tgt)


def _chunk_loss_vocab(hb: torch.Tensor, tb: torch.Tensor, w: torch.Tensor,
                      on: L.OnMesh, axes, v0: int) -> torch.Tensor:
    """:func:`_chunk_loss` with the vocabulary split over ``axes``: ``w``
    holds this rank's columns from ``v0``.  Each rank's max (held
    constant: the log-sum-exp does not depend on it), sum of exponentials
    and target logit (zero where another rank owns the target) are
    gathered (``Mesh.share``) and combined in rank order, so every rank
    holds the same loss and differentiates its own columns."""
    logits = (hb @ w).float()
    m = logits.detach().amax(dim=-1, keepdim=True)
    s = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    local = tb[..., None] - v0
    own = (local >= 0) & (local < logits.shape[-1])
    tgt = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)) * own
    parts = on.mesh.share(torch.cat([m, s, tgt], dim=-1)[None], axes, 0,
                          part="vocab")
    M = parts[..., :1].amax(dim=0)
    se, tg = None, None
    for r in range(parts.shape[0]):
        e = torch.exp(parts[r, ..., :1] - M) * parts[r, ..., 1:2]
        t = parts[r, ..., 2:]
        se, tg = (e, t) if se is None else (se + e, tg + t)
    return torch.sum(M + torch.log(se) - tg)


def lm_loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            cross_src: torch.Tensor | None = None,
            rules: ShardingRules = NO_SHARD, mesh=None,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar), the mean over ``B * (S -
    1)`` positions, computed ``loss_chunk`` positions at a time so the
    [B, S, V] float32 logits never exist whole.  Under autograd each
    chunk's logits are recomputed in the backward (the reference's
    ``@jax.checkpoint``), as is each layer (``forward``'s ``remat``).

    Over a mesh (``rules`` / ``mesh`` as ``forward``'s), ``tokens`` hold
    this rank's batch rows and every rank returns the reference's global
    mean.  With the vocabulary split (the tied embedding's rows or
    ``lm_head``'s columns over the tensor axis), the final hidden is
    gathered along the sequence and each chunk's loss is
    vocabulary-parallel (:func:`_chunk_loss_vocab`; a group of one rank
    takes the plain loss); with it whole, each rank takes the positions
    of its sequence block.  The ranks' sums are summed over the batch
    axes (and the sequence's, where it split the positions:
    ``Mesh.sum_partials``, whose backward is the identity), over the
    global ``B * (S - 1)``: each rank's gradients are partials that the
    train step sums."""
    hidden = forward(cfg, params, tokens, cross_src=cross_src, rules=rules,
                     mesh=mesh)
    B, S = tokens.shape[0], tokens.shape[1] - 1
    targets = tokens[:, 1:].long()
    w = params["embed"].T if cfg.tie_embeddings else params.get("lm_head")
    chunk_loss, extra, axes, v0 = _chunk_loss, (), (), 0
    if mesh is None:
        h = hidden[:, :-1]
    else:
        on = L.OnMesh(mesh, rules)
        w, axes = L.vocab_columns(on, params, param_specs(cfg),
                                  hidden.shape[-1],
                                  tied=cfg.tie_embeddings)
        if axes:
            h = L.seq_gather(on, hidden)[:, :-1]
            if on.n(axes) > 1:
                v0 = on.span(cfg.vocab_size, axes)[0]
                chunk_loss = functools.partial(_chunk_loss_vocab, on=on,
                                               axes=axes, v0=v0)
        else:
            s0, sl = on.seq_span(S + 1) if on.sp else (0, S + 1)
            n = max(0, min(sl, S - s0))
            h, targets = hidden[:, :n], targets[:, s0:s0 + n]
            extra = L._axes(rules.act_seq) if on.sp else ()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], loss_chunk):
        args = (h[:, c0:c0 + loss_chunk], targets[:, c0:c0 + loss_chunk], w)
        if torch.is_grad_enabled():
            total = total + ckpt.checkpoint(chunk_loss, *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
        else:
            total = total + chunk_loss(*args)
    if mesh is not None:
        axes = _batch_axes(rules)
        B *= math.prod(mesh.shape[a] for a in axes)
        total = mesh.sum_partials(total, axes + extra, part="loss")
    return total / (B * S)


def _batch_axes(rules: ShardingRules) -> tuple:
    """The mesh axes ``rules.batch`` splits the batch rows over."""
    b = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    return tuple(a for a in b if a is not None)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def _cache_stage(cfg: ModelConfig, spec: StageSpec, stack: tuple[int, int],
                 *, batch: int, max_seq: int, rules: ShardingRules) -> dict:
    """One stage's cache leaves as (shape, dtype, spec): self-attention
    K/V (a ring of ``window`` slots for windowed layers; the sequence over
    ``rules.seq``), the cross layers' K/V of the source, the Mamba conv
    history and SSM state (float32)."""
    KV, hd, dt, b = cfg.num_kv_heads, cfg.hd, cfg.dtype, rules.batch
    slen = min(spec.window, max_seq) if spec.window else max_seq
    leaves = {}
    if spec.kind in ("attn", "attn_cross", "hybrid"):
        leaves["k"] = leaves["v"] = ((batch, slen, KV, hd), dt,
                                     (b, rules.seq, None, None))
    if spec.kind in ("attn_cross", "cross"):
        leaves["xk"] = leaves["xv"] = ((batch, cfg.cross_seq, KV, hd), dt,
                                       (b, None, None, None))
    if spec.kind in ("mamba", "hybrid"):
        leaves["conv"] = ((batch, cfg.conv_kernel - 1, cfg.d_inner), dt,
                          (b, None, "model"))
        leaves["ssm"] = ((batch, cfg.d_inner, cfg.ssm_state), torch.float32,
                         (b, "model", None))
    return {name: (stack + shape, dtype, P(*(None,) * len(stack), *sp))
            for name, (shape, dtype, sp) in leaves.items()}


def _build_cache(cfg: ModelConfig, make, *, batch: int, max_seq: int,
                 rules: ShardingRules) -> list:
    """A list of patterns of stages of leaf dicts, each leaf ``make(shape,
    dtype, spec)``."""
    return [[{name: make(*leaf) for name, leaf in _cache_stage(
        cfg, st, (pat.repeats, st.count), batch=batch, max_seq=max_seq,
        rules=rules).items()} for st in pat.stages] for pat in cfg.patterns]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list:
    """Zero decode caches: a list of patterns of stages of leaf dicts."""
    device = resolve_device(device)
    return _build_cache(
        cfg, lambda shape, dtype, _: torch.zeros(shape, dtype=dtype,
                                                 device=device),
        batch=batch, max_seq=max_seq, rules=NO_SHARD)


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                 rules: ShardingRules = NO_SHARD) -> list:
    """The decode caches on the meta device (allocates nothing)."""
    return _build_cache(
        cfg, lambda shape, dtype, _: torch.empty(shape, dtype=dtype,
                                                 device="meta"),
        batch=batch, max_seq=max_seq, rules=rules)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int,
                rules: ShardingRules) -> list:
    """The decode caches' partition specs (the reference's: batch over
    ``rules.batch``, self-attention sequence over ``rules.seq``, the SSM's
    d_inner over ``model``; the stack dims whole)."""
    return _build_cache(cfg, lambda shape, dtype, spec: spec, batch=batch,
                        max_seq=max_seq, rules=rules)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _layer_decode(cfg: ModelConfig, spec: StageSpec, lp: dict, cache: dict,
                  x: torch.Tensor, *, pos: int, ls: dict | None = None,
                  on: L.OnMesh | None = None) -> torch.Tensor:
    """One layer of one-token decode; ``cache`` holds this layer's cache
    views, updated in place.  Over a mesh (``on``, ``ls`` the layer's
    specs) the self-attention caches this rank's block of the positions,
    the Mamba states its channels."""
    kind = spec.kind
    if kind == "cross":
        return _gated_cross(cfg, lp, ls, x, (cache["xk"], cache["xv"]), on)
    if kind not in ("attn", "attn_cross", "mamba", "hybrid"):
        raise ValueError(f"layer kind {kind} has no decode step")
    h = _norm(lp["ln1"], x, cfg)
    if kind in ("mamba", "hybrid"):
        if on is None:
            m, _, _ = L.mamba_decode(lp["mixer"], h, cache["conv"],
                                     cache["ssm"], d_state=cfg.ssm_state)
        else:
            m, _, _ = L.mamba_decode_mesh(lp["mixer"], ls["mixer"], h,
                                          cache["conv"], cache["ssm"], on,
                                          d_state=cfg.ssm_state,
                                          d_inner=cfg.d_inner)
        if kind == "mamba":
            return x + m
    kw = dict(window=spec.window, **_attn_kwargs(cfg))
    if on is None:
        a, _, _ = L.decode_self_attention(lp["attn"], h, cache["k"],
                                          cache["v"], pos, **kw)
    else:
        a, _, _ = L.decode_attention_mesh(lp["attn"], ls["attn"], h,
                                          cache["k"], cache["v"], pos, on,
                                          **kw)
    x = x + (_fuse(cfg, lp, a, m) if kind == "hybrid" else a)
    kv = (cache["xk"], cache["xv"]) if kind == "attn_cross" else None
    return _cross_and_ffn(cfg, kind, lp, ls, x, kv, on)


def decode_step(cfg: ModelConfig, params: dict, cache: list,
                tokens: torch.Tensor, pos: int, *,
                rules: ShardingRules = NO_SHARD, mesh=None):
    """One-token decode.  tokens: [B, 1]; ``pos`` an int (aligned batch).
    ``rules`` / ``mesh`` (the decode rules): tokens hold this rank's batch
    rows, the tree this rank's blocks and the cache the layout
    ``prefill_step`` over the same mesh gives it; the logits are
    whole on every rank.

    Returns (logits [B, V] float32, cache).  The cache is updated in place
    (the reference returns a new one) and returned.
    """
    pos = int(pos)
    on = None if mesh is None else L.OnMesh(mesh, rules)
    if on is not None and on.sp:
        raise ValueError("decode takes the decode rules (no sequence "
                         "parallelism): make_rules(kind='decode')")
    x = _embed_tokens(cfg, params, tokens, on)
    if cfg.max_position:
        # the reference's dynamic_slice clamps the row: positions past the
        # table read its last row
        x = x + params["pos_embed"][min(pos, cfg.max_position - 1)]
    blocks = params["blocks"]
    specs = None if on is None else param_specs(cfg)["blocks"]
    for (spec, pi, j, r, c), _ in trips.each(_layers(cfg.patterns),
                                             _stage_key):
        lp = _layer(blocks[pi][j], r, c)
        lc = {k: v[r, c] for k, v in cache[pi][j].items()}
        x = _layer_decode(cfg, spec, lp, lc, x, pos=pos, on=on,
                          ls=None if on is None else
                          _layer_specs(specs[pi][j]))
    x = _norm(params["final_norm"], x, cfg)
    return _logits(cfg, params, x, on)[:, 0], cache


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


def _mamba_prefill(cfg: ModelConfig, mp: dict, h: torch.Tensor):
    """The Mamba mixer over the prompt, with its final states: the conv
    history (the last K-1 inputs before the conv; zeros before the first
    token) and the SSM state."""
    xc, z = (h @ mp["in_proj"]).chunk(2, dim=-1)
    xc_conv = L._act("silu", L._causal_conv(xc, mp["conv_w"], mp["conv_b"]))
    dt, Bc, Cc = L._ssm_params(mp, xc_conv, d_state=cfg.ssm_state)
    y, h_last = L.selective_scan(xc_conv, dt, Bc, Cc, mp["A_log"], mp["D"])
    out = (y * L._act("silu", z)) @ mp["out_proj"]
    K1 = cfg.conv_kernel - 1
    conv_state = F.pad(xc, (0, 0, K1, 0))[:, -K1:]
    return out, conv_state.to(cfg.dtype), h_last


def _layer_prefill(cfg: ModelConfig, spec: StageSpec, lp: dict,
                   x: torch.Tensor, *, positions: torch.Tensor, max_seq: int,
                   cross_src):
    """Like ``_layer_fwd`` but also returns this layer's cache leaves (a
    dict); chunked attention only above ``PREFILL_CHUNK_THRESHOLD``
    tokens."""
    kind = spec.kind
    cache: dict = {}
    if kind == "cross":
        cache["xk"], cache["xv"] = kv = _cross_kv(cfg, lp, None, cross_src,
                                                  None)
        return _gated_cross(cfg, lp, None, x, kv, None), cache
    if kind not in ("attn", "attn_cross", "mamba", "hybrid"):
        raise ValueError(f"layer kind {kind} has no prefill step")
    h = _norm(lp["ln1"], x, cfg)
    if kind in ("mamba", "hybrid"):
        m, cache["conv"], cache["ssm"] = _mamba_prefill(cfg, lp["mixer"], h)
        if kind == "mamba":
            return x + m, cache
    B, S, _ = x.shape
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
    a = o.reshape(B, S, -1) @ lp["attn"]["wo"]
    cache["k"] = _fill_kv_cache(k.to(cfg.dtype), spec.window, S, max_seq)
    cache["v"] = _fill_kv_cache(v.to(cfg.dtype), spec.window, S, max_seq)
    x = x + (_fuse(cfg, lp, a, m) if kind == "hybrid" else a)
    kv = None
    if kind == "attn_cross":
        cache["xk"], cache["xv"] = kv = _cross_kv(cfg, lp, None, cross_src,
                                                  None)
    return _cross_and_ffn(cfg, kind, lp, None, x, kv, None), cache


def prefill_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 max_seq: int | None = None,
                 cross_src: torch.Tensor | None = None,
                 rules: ShardingRules = NO_SHARD, mesh=None):
    """Forward over the prompt; returns (last-token logits [B, V] float32,
    filled cache).

    ``max_seq`` sizes the cache (>= prompt length; default the prompt
    length).  Windowed layers fill their ring buffers at ring-consistent
    slots (slot = position % window), so ``decode_step`` continues
    seamlessly.  ``cross_src``: whisper's frames (encoded here) or
    llama-vision's patches; the cross layers cache their K/V over it.
    ``rules`` / ``mesh``: tokens, source and the cache made hold this
    rank's batch rows, the tree this rank's blocks; the cache is laid out
    for ``decode_step`` under the decode rules of the same mesh and batch:
    each self-attention K / V this rank's block of the positions over
    ``rules.cache_seq(mesh)`` (an even split), the Mamba states this
    rank's channels.  Each stage's leaves are stacked from the
    layers' outputs, as the reference's scan stacks them.
    """
    B, S = tokens.shape
    max_seq = max_seq or S
    on = None if mesh is None else L.OnMesh(mesh, rules)
    x = _embed(cfg, params, tokens, on)
    positions = torch.arange(S, device=x.device)
    cross_src = _cross_source(cfg, params, cross_src, rules=rules, mesh=mesh)
    cache: list = [[{} for _ in pat.stages] for pat in cfg.patterns]
    blocks = params["blocks"]
    specs = None if on is None else param_specs(cfg)["blocks"]
    for (spec, pi, j, r, c), _ in trips.each(_layers(cfg.patterns),
                                             _stage_key):
        lp = _layer(blocks[pi][j], r, c)
        if on is None:
            x, leaves = _layer_prefill(cfg, spec, lp, x, positions=positions,
                                       max_seq=max_seq, cross_src=cross_src)
        else:
            leaves = {}
            x = _layer_mesh(cfg, spec, lp, _layer_specs(specs[pi][j]), x,
                            positions=positions, cross_src=cross_src, on=on,
                            threshold=PREFILL_CHUNK_THRESHOLD, cache=leaves,
                            max_seq=max_seq)
            leaves = _seq_blocks(leaves, mesh, rules.cache_seq(mesh))
        stage = cache[pi][j]
        for name, leaf in leaves.items():
            if name not in stage:
                stage[name] = leaf.new_empty(
                    (cfg.patterns[pi].repeats, spec.count) + leaf.shape)
            stage[name][r, c] = leaf
    x = _norm(params["final_norm"], x, cfg)
    last = x[:, -1:]
    if on is not None and on.sp and on.n(rules.act_seq) > 1:
        # the last rank's block holds it
        last = mesh.all_gather(last, rules.act_seq, 1, part="sp")[:, -1:]
    return _logits(cfg, params, last, on)[:, 0], cache


def _seq_blocks(leaves: dict, mesh, seq) -> dict:
    """A layer's self-attention K / V cut to this rank's block of the
    positions over the axes ``seq``, which must split them evenly."""
    axes = L._axes(seq)
    n = mesh.group_size(axes)
    for name in ("k", "v"):
        if name in leaves and axes:
            slen = leaves[name].shape[1]
            if slen % n:
                raise ValueError(f"a cache of {slen} positions does not "
                                 f"split over {axes} of {n}")
            at = mesh.flat_index(axes) * (slen // n)
            leaves[name] = leaves[name].narrow(1, at, slen // n)
    return leaves


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
        self.cfg = cfg
        self.params = _ParamTree(params)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, tokens: torch.Tensor,
                cross_src: torch.Tensor | None = None) -> torch.Tensor:
        return forward(self.cfg, self.tree(), tokens, cross_src=cross_src)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return logits_from_hidden(self.cfg, self.tree(), hidden)

    def loss(self, tokens: torch.Tensor,
             cross_src: torch.Tensor | None = None,
             loss_chunk: int = 1024) -> torch.Tensor:
        return lm_loss(self.cfg, self.tree(), tokens, cross_src=cross_src,
                       loss_chunk=loss_chunk)

    def prefill(self, tokens: torch.Tensor, max_seq: int | None = None,
                cross_src: torch.Tensor | None = None):
        return prefill_step(self.cfg, self.tree(), tokens, max_seq=max_seq,
                            cross_src=cross_src)

    def decode(self, cache: list, tokens: torch.Tensor, pos: int):
        return decode_step(self.cfg, self.tree(), cache, tokens, pos)
