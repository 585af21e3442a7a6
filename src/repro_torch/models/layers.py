"""Model-layer primitives of every assigned architecture (port of
``repro/models/layers.py``: the basic blocks, self- and cross-attention
and the decode path, the MoE FFN, the Mamba-1 mixer, embedding and the
LM head).

Plain functions on tensors, ``(params, x, ...) -> y``, with the reference's
parameter names and layouts (``x @ w`` with ``w`` ``[in, out]``; heads in
``[B, S, H, D]``).  The reference's ``rules`` / ``shard`` arguments are
GSPMD placement hints only and are dropped here.  Attention, the expert
dispatch and the selective scan are written in plain torch ops (matmul,
``where``, ``softmax``, sorts and gathers), as the reference writes them in
``jnp`` outside any Pallas kernel.

Precision follows the reference's order: attention logits in float32 from
the input dtype's q and k (its ``preferred_element_type=float32``),
probabilities cast back to the input dtype before the PV product, norms in
float32, the LM head multiplied in the activation dtype and then cast to
float32, the activations and ``softplus`` op for op as ``jax.nn`` writes
them, router logits and the SSM state in float32.  Masked logits are
filled with -1e30, not -inf.

Sharding: :class:`ShardingRules` and the spec type :class:`P` are the
reference's.  With no mesh every layer is the one-device function.  Over
a ``launch.mesh.Mesh`` (the ``*_mesh`` functions, with an :class:`OnMesh`
and the layer's leaves as this rank's blocks by ``param_specs``, with
their specs) a layer places its work where the reference's hints place
it: a dim a leaf's spec splits over ``rules.fsdp`` is all-gathered just
before use (:func:`gather_leaf`; its backward, a sum-scatter, hands back
a gradient block) and the gathered copy dropped after; the MLP's ``up`` /
``gate`` columns and ``down`` rows, the query heads and ``wo``'s rows,
the Mamba mixer's channels and ``x_proj`` / ``out_proj`` rows and the
embedding's vocabulary rows stay split over ``rules.tensor``
(tensor-parallel: the row-parallel partials are summed over it), and
``wk`` / ``wv`` are gathered whole, as the reference keeps K and V
whole on every rank.  A leaf whose block does not hold whole heads, or
whose dim the spec left whole, is gathered (or used) whole and computed
whole.  Under sequence parallelism (``rules.act_seq``, train and
prefill) the residual holds this rank's block of the sequence: a norm's
output is gathered along it before a tensor-parallel product and the
row-parallel sums become sum-scatters along it; with
``seq_parallel_attn`` the queries stay sequence-split and only K and V
are gathered.  A sequence that does not split evenly (whisper's 1,500
frames over 16 ranks) is held in ceiling blocks, padded for the gathers
and sum-scatters (``OnMesh.seq``).  In decode the KV caches hold this
rank's block of positions over ``rules.seq`` and the attention combines
the blocks' partial maxima, sums and PV products.  Where a split's group has one
rank the arithmetic is that of no mesh (its collectives pass through a
one-rank group), so a 1 x 1 mesh is bit-equal to no mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch import trips
from repro_torch.tree import tree_map

NEG = -1e30


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec, the port's ``jax.sharding.PartitionSpec``: one
    entry per leading dim, ``None`` (whole), an axis name, or a tuple of
    axis names (the dim split over their product, the first axis major).
    Trailing dims it does not name are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def is_spec(x) -> bool:
    """A leaf of a spec tree (``tree_leaves(..., is_leaf=is_spec)``)."""
    return isinstance(x, P) or x is None


def _span(mesh, size: int, axes) -> tuple[int, int]:
    """This rank's ceiling block ``(start, length)`` of a dim of ``size``
    split over ``axes``: blocks of ``ceil(size / n)``, the last shorter or
    empty."""
    axes = _axes(axes)
    if not axes:
        return 0, size
    chunk = -(-size // mesh.group_size(axes))
    start = min(mesh.flat_index(axes) * chunk, size)
    return start, min(chunk, size - start)


def _block(mesh, x: torch.Tensor, spec) -> torch.Tensor:
    for dim, ax in enumerate(tuple(spec or ())):
        if _axes(ax):
            x = x.narrow(dim, *_span(mesh, x.shape[dim], ax))
    return x


def shard_tree(tree, spec_tree, mesh):
    """This rank's block of every leaf of ``tree`` by ``spec_tree`` (the
    same structure, ``P`` or None leaves) on ``mesh`` (a
    ``launch.mesh.Mesh``): a dim split over axes of ``n`` ranks in all
    comes in blocks of ``ceil(dim / n)``, as ``dryrun._sharded_bytes``
    reckons them (the last one shorter, or empty).  Views, no copy.  It stands in for the reference's ``named``
    + ``device_put``."""
    return tree_map(lambda spec, x: _block(mesh, x, spec), spec_tree, tree,
                    is_leaf=is_spec)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical -> mesh axis mapping (the reference's fields).

    ``batch`` may span several mesh axes (("pod", "data")), ``tensor`` is
    the tensor-parallel axis (the MoE's expert axis), ``fsdp`` the
    parameter-sharding axis; ``seq`` the decode caches' sequence axes;
    ``act_seq`` the residual's sequence axis under sequence parallelism.
    ``moe_gather_weights``: True gathers the FSDP-sharded expert weights on
    use (train / prefill); False keeps them 2-D sharded and gathers the
    tokens over the batch axes (decode).  Any field may be None to
    disable that form of parallelism.
    """

    batch: Any = None
    tensor: Any = None
    fsdp: Any = None
    seq: Any = None
    act_seq: Any = None
    moe_gather_weights: bool = True
    seq_parallel_attn: bool = False

    def cache_seq(self, mesh) -> Any:
        """The decode caches' sequence axes on ``mesh`` (a
        ``launch.mesh.Mesh``) for these rules' batch: the tensor axis where
        the batch rows split over the batch axes, else (a batch that fills
        none of them) every axis of the mesh.  The decode rules' ``seq``,
        and the layout in which prefill leaves the caches."""
        return self.tensor if self.batch is not None else mesh.axis_names


NO_SHARD = ShardingRules()


def _axes(entry) -> tuple[str, ...]:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    return entry if isinstance(entry, tuple) else ((entry,) if entry else ())


def spec_axes(spec, dim: int) -> tuple[str, ...]:
    """The mesh axes ``spec`` splits ``dim`` over (none past its end)."""
    spec = tuple(spec or ())
    return _axes(spec[dim]) if dim < len(spec) else ()


@dataclasses.dataclass(frozen=True)
class OnMesh:
    """A layer's mesh (a ``launch.mesh.Mesh``) and rules.  Sequence
    parallelism (``rules.act_seq``) splits the sequence over the tensor
    axis itself (``make_rules``'s), so that a tensor-parallel product's
    partials are summed and cut along the sequence in one collective.
    ``seq``: the residual's whole sequence length, where it may not
    split evenly (whisper's 1,500 frames over 16 ranks): the residual is
    then held in ``shard_tree``'s ceiling blocks (the last shorter), as
    XLA pads an uneven split; None, it splits evenly."""
    mesh: Any
    rules: ShardingRules
    seq: int | None = None

    def __post_init__(self):
        act, t = self.rules.act_seq, self.rules.tensor
        if act is not None and _axes(act) != _axes(t):
            raise ValueError(f"sequence parallelism over {act!r} needs the "
                             f"tensor axis {t!r} to be the same")

    @property
    def sp(self) -> bool:
        return self.rules.act_seq is not None

    def n(self, axes) -> int:
        return self.mesh.group_size(axes)

    def span(self, size: int, axes) -> tuple[int, int]:
        """This rank's ``shard_tree`` block ``(start, length)`` of a dim
        of ``size`` split over ``axes``."""
        return _span(self.mesh, size, axes)

    def seq_span(self, S: int) -> tuple[int, int]:
        """This rank's block of a sequence of ``S`` under sequence
        parallelism (the sequence must split evenly)."""
        n = self.n(self.rules.act_seq)
        if S % n:
            raise ValueError(f"a sequence of {S} does not split over "
                             f"{self.rules.act_seq!r} of {n}")
        return self.mesh.flat_index(self.rules.act_seq) * (S // n), S // n


def _part(rules: ShardingRules, axes) -> str:
    return "fsdp" if set(_axes(axes)) & set(_axes(rules.fsdp)) else "tp"


def gather_padded(mesh, x: torch.Tensor, axes, dim: int, size: int, *,
                  part: str) -> torch.Tensor:
    """``x``, this rank's ceiling block of a dim of ``size`` split over
    ``axes``, gathered whole along ``dim``: a short or empty block is
    padded to the ceiling first and the whole trimmed to ``size`` after
    (under autograd the pad's cotangent is dropped)."""
    axes = _axes(axes)
    if not axes:
        return x
    chunk = -(-size // mesh.group_size(axes))
    if x.shape[dim] < chunk:
        pad = list(x.shape)
        pad[dim] = chunk - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    out = mesh.all_gather(x, axes, dim, part=part)
    return out if out.shape[dim] == size else out.narrow(dim, 0, size)


def gather_leaf(on: OnMesh, w: torch.Tensor, spec, sizes: dict
                ) -> torch.Tensor:
    """Leaf block ``w`` gathered whole along each dim of ``sizes``
    (``{dim: whole length}``) over the axes its spec splits it (FSDP's
    ``fsdp`` gathers count as ``fsdp``, the others as ``tp``); a dim the
    spec leaves whole passes as it is."""
    for dim, size in sizes.items():
        axes = spec_axes(spec, dim)
        if axes:
            if w.shape[dim] != on.span(size, axes)[1]:
                raise ValueError(f"a leaf of shape {tuple(w.shape)} is not "
                                 f"this rank's block of dim {dim} of {size} "
                                 f"over {axes}")
            w = gather_padded(on.mesh, w, axes, dim, size,
                              part=_part(on.rules, axes))
        elif w.shape[dim] != size:
            raise ValueError(f"a leaf of shape {tuple(w.shape)} whose spec "
                             f"{spec} leaves dim {dim} of {size} whole")
    return w


def local_block(on: OnMesh, w: torch.Tensor, spec, dim: int, size: int,
                axes) -> torch.Tensor:
    """Leaf ``w``, checked to be this rank's block over ``axes`` of a dim
    of ``size`` (its spec must split ``dim`` over them)."""
    if set(spec_axes(spec, dim)) != set(_axes(axes)) or \
            w.shape[dim] != on.span(size, axes)[1]:
        raise ValueError(f"a leaf of shape {tuple(w.shape)} by {spec} is "
                         f"not this rank's block of dim {dim} over {axes}")
    return w


def seq_gather(on: OnMesh, x: torch.Tensor) -> torch.Tensor:
    """The residual layout's value made whole along the sequence (dim 1):
    gathered over ``act_seq`` under sequence parallelism (``sp``; ceiling
    blocks padded, see ``OnMesh.seq``), else as it is."""
    if not on.sp:
        return x
    axes = on.rules.act_seq
    return gather_padded(on.mesh, x, axes, 1,
                         on.seq or x.shape[1] * on.n(axes), part="sp")


def seq_own(on: OnMesh, y: torch.Tensor) -> torch.Tensor:
    """A value whole along the sequence and alike on the tensor group, cut
    to the residual layout (this rank's block under ``sp``)."""
    if not on.sp:
        return y
    return y.narrow(1, *on.span(y.shape[1], on.rules.act_seq))


def reduce_out(on: OnMesh, y: torch.Tensor, part: str = "sp"
               ) -> torch.Tensor:
    """A row-parallel product's partials over the tensor axis, summed into
    the residual layout: sum-scattered along the sequence under ``sp``
    (``part``; a sequence that does not split evenly padded to the
    ceiling blocks first and this rank's block cut after), else summed
    (``tp``)."""
    if not on.sp:
        return on.mesh.sum_partials(y, on.rules.tensor,
                                    part="tp" if part == "sp" else part)
    axes = on.rules.act_seq
    S, n = y.shape[1], on.n(axes)
    if S % n == 0:
        return on.mesh.sum_scatter(y, axes, 1, part=part)
    y = F.pad(y, (0, 0, 0, -(-S // n) * n - S))
    return on.mesh.sum_scatter(y, axes, 1, part=part).narrow(
        1, 0, on.span(S, axes)[1])


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a weakly typed Python
    constant to the array's dtype before the operation (a Python float,
    so no tensor is made on the device)."""
    return torch.tensor(value, dtype=dtype).item()


# ---------------------------------------------------------------------------
# Basic blocks
# ---------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if plus_one:                      # gemma stores scale as (1 + w)
        w = 1.0 + w
    return (y * w).to(x.dtype)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def apply_norm(params: dict, x: torch.Tensor, *, kind: str, eps: float,
               plus_one: bool = False) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(params, x, eps)
    return rms_norm(params["scale"], x, eps, plus_one=plus_one)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, D_head]; positions: [S] or [B, S].
    Computed in float32, returned in x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq            # [..., S, half]
    ang = ang[..., None, :]                              # [..., S, 1, half]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` and the tanh approximation of ``jax.nn.gelu``, op
    for op in x's dtype: JAX rounds after every operation (and its
    constants first), so in bfloat16 these equal the reference's bit for
    bit where ``F.silu`` / ``F.gelu``, rounding once, differ in ~40% of
    the elements by an ulp."""
    if name == "silu":
        return x * (1 / (1 + torch.exp(-x)))
    if name == "gelu":
        c = _const(math.sqrt(2 / math.pi), x.dtype)
        k = _const(0.044715, x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))
    raise ValueError(f"unknown activation {name}")


def mlp(params: dict, x: torch.Tensor, *, activation: str, glu: bool
        ) -> torch.Tensor:
    """(Gated) MLP: ``act(x @ gate) * (x @ up)``, then ``@ down``."""
    h = x @ params["up"]
    if glu:
        h = _act(activation, x @ params["gate"]) * h
    else:
        h = _act(activation, h)
    return h @ params["down"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
         head_dim: int, qkv_bias: bool):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv, head_dim),
            v.reshape(B, S, n_kv, head_dim))


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, H, D] by repeating each kv head."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=-2)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum('bqhd,bkhd->bhqk')`` in float32 from q and k as given."""
    return q.float().permute(0, 2, 1, 3) @ k.float().permute(0, 2, 3, 1)


def _pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum('bhqk,bkhd->bhqd')`` in v's dtype."""
    return probs @ v.permute(0, 2, 1, 3)


def attention_core(q, k, v, *, causal: bool, window: int = 0,
                   q_offset: int = 0, kv_valid=None) -> torch.Tensor:
    """Dense attention.  q: [B, Sq, H, D]; k, v: [B, Sk, H, D].

    ``q_offset`` is the absolute position of q[0] (decode: current pos).
    ``kv_valid`` optionally masks cache slots ([B, Sk] or [Sk]).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    logits = _scores(q, k) * (1.0 / math.sqrt(D))        # [B, H, Sq, Sk]
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask = mask[None, None]
    if kv_valid is not None:
        kvm = kv_valid if kv_valid.dim() == 2 else kv_valid[None]
        mask = mask & kvm[:, None, None, :]
    logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _pv(probs, v).permute(0, 2, 1, 3)             # [B, Sq, H, D]


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks (a Python loop where the
    reference scans).  Never materialises [B, H, Sq, Sk]; the peak
    transient is [B, H, Sq, chunk].  ``q_offset``: q[0]'s position."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sk <= chunk:
        return attention_core(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qpos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        logits = _scores(q, kb) * scale
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        mask = (kpos[None, :] < Sk).expand(Sq, chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask[None, None], logits, NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _pv(p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)           # [B, Sq, H, D]


CHUNK_THRESHOLD = 2048     # tokens above which self-attention is chunked


def self_attention(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                   head_dim: int, qkv_bias: bool, rope_theta: float,
                   causal: bool, window: int, positions: torch.Tensor,
                   use_rope: bool = True,
                   chunk_threshold: int = CHUNK_THRESHOLD) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill path); chunked above
    ``chunk_threshold`` tokens."""
    q, k, v = _qkv(params, x, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                   qkv_bias=qkv_bias)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    kf = _repeat_kv(k, n_heads)
    vf = _repeat_kv(v, n_heads)
    if x.shape[1] > chunk_threshold:
        o = chunked_attention(q, kf, vf, causal=causal, window=window)
    else:
        o = attention_core(q, kf, vf, causal=causal, window=window)
    o = o.reshape(x.shape[0], x.shape[1], n_heads * head_dim)
    return o @ params["wo"]


def cross_attention(params: dict, x: torch.Tensor, kv_src, *, n_heads: int,
                    n_kv: int, head_dim: int, qkv_bias: bool
                    ) -> torch.Tensor:
    """Cross-attention (no mask, no rope).  ``kv_src`` is either the
    encoder / patch sequence [B, Se, D] (keys projected here) or a
    precomputed ``(k, v)`` tuple (decode)."""
    B, Sq, _ = x.shape
    q = x @ params["wq"]
    if qkv_bias:
        q = q + params["bq"]
    q = q.reshape(B, Sq, n_heads, head_dim)
    if isinstance(kv_src, tuple):
        k, v = kv_src
    else:
        k, v = project_cross_kv(params, kv_src, n_kv=n_kv, head_dim=head_dim,
                                qkv_bias=qkv_bias)
    o = attention_core(q, _repeat_kv(k, n_heads), _repeat_kv(v, n_heads),
                       causal=False)
    return o.reshape(B, Sq, n_heads * head_dim) @ params["wo"]


def project_cross_kv(params: dict, kv_src: torch.Tensor, *, n_kv: int,
                     head_dim: int, qkv_bias: bool):
    """The cross-attention keys and values of ``kv_src`` [B, Se, D], each
    [B, Se, n_kv, head_dim] (what prefill caches as ``xk`` / ``xv``)."""
    B, Se, _ = kv_src.shape
    k = kv_src @ params["wk"]
    v = kv_src @ params["wv"]
    if qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return (k.reshape(B, Se, n_kv, head_dim),
            v.reshape(B, Se, n_kv, head_dim))


# ---------------------------------------------------------------------------
# Decode-path attention (KV cache, ring buffers for windows)
# ---------------------------------------------------------------------------

def _decode_qkv(params: dict, x: torch.Tensor, pos: int, *, n_heads: int,
                n_kv: int, head_dim: int, qkv_bias: bool, rope_theta: float,
                use_rope: bool):
    """The new token's q, k, v [B, 1, heads, head_dim], rotated to ``pos``."""
    q, k, v = _qkv(params, x, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                   qkv_bias=qkv_bias)
    if use_rope:
        posv = torch.full((1,), pos, device=x.device)
        q = rope(q, posv, rope_theta)
        k = rope(k, posv, rope_theta)
    return q, k, v


def _decode_attend(q, k, v, cache_k, cache_v, pos: int, *, n_heads: int,
                   head_dim: int, window: int, start: int = 0,
                   S_cache: int | None = None, gather=None) -> torch.Tensor:
    """The decode attention over a block of cache slots -> o [B, 1,
    n_heads * head_dim].  ``cache_k`` / ``cache_v`` hold slots ``[start,
    start + L)`` of ``S_cache`` (default: all of them); the new token's K /
    V row is written in place where the block holds its slot (``pos``, or
    ``pos % S_cache`` for a ring).  With ``gather`` None the block is the
    whole cache and takes the softmax; else ``gather`` (over the other
    blocks' ranks) returns every block's partial ``[m | s | pv]`` in rank
    order, combined by :func:`_combine_blocks`."""
    L = cache_k.shape[1]
    S_cache = S_cache or L
    slot = pos % S_cache if window else pos
    if slot >= S_cache:
        raise IndexError(f"position {pos} past a cache of {S_cache}")
    if start <= slot < start + L:
        cache_k[:, slot - start] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - start] = v[:, 0].to(cache_v.dtype)
    # validity: slot i holds a position (for a ring: the newest S_cache
    # positions).  The reference's precedence makes the window case
    # ((idx <= pos) & (idx > pos - S_cache)) | (pos >= S_cache).
    idx = torch.arange(start, start + L, device=q.device)
    valid = idx <= pos
    if window:
        valid = (valid & (idx > pos - S_cache)) | (pos >= S_cache)
    kf = _repeat_kv(cache_k.to(q.dtype), n_heads)
    vf = _repeat_kv(cache_v.to(q.dtype), n_heads)
    logits = _scores(q, kf) * (1.0 / math.sqrt(head_dim))
    logits = torch.where(valid[None, None, None, :], logits, NEG)
    if gather is None:
        o = _pv(torch.softmax(logits, dim=-1).to(q.dtype), vf)
    else:
        m = logits.amax(dim=-1, keepdim=True)                # [B, H, 1, 1]
        p = torch.exp(logits - m)
        part = torch.cat([m, p.sum(dim=-1, keepdim=True),
                          _pv(p, vf.float())], dim=-1)
        o = _combine_blocks(gather(part)).to(q.dtype)
    B = q.shape[0]
    return o.permute(0, 2, 1, 3).reshape(B, 1, n_heads * head_dim)


def _combine_blocks(parts: torch.Tensor) -> torch.Tensor:
    """The decode attention's per-block ``[m | s | pv]`` (float32, the
    blocks on dim 0 in rank order) combined left to right: ``sum_r
    exp(m_r - M) pv_r / sum_r exp(m_r - M) s_r``, M the largest m."""
    M = parts[..., :1].amax(dim=0)
    num = den = None
    for r in range(parts.shape[0]):
        wr = torch.exp(parts[r, ..., :1] - M)
        dn, nm = wr * parts[r, ..., 1:2], wr * parts[r, ..., 2:]
        num, den = (nm, dn) if num is None else (num + nm, den + dn)
    return num / den


def decode_self_attention(params: dict, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, *, n_heads: int, n_kv: int,
                          head_dim: int, qkv_bias: bool, rope_theta: float,
                          window: int, use_rope: bool = True):
    """One-token decode.  x: [B, 1, D]; cache_k/v: [B, S_cache, KV, D_head];
    ``pos`` the position of the new token (an int: the batch is aligned).

    For windowed layers the cache is a ring buffer of size ``window`` and
    position p lives at slot p % S_cache; for global layers S_cache is the
    full max context.  Unlike the reference, which returns new caches, the
    new token's K/V row is written into ``cache_k`` / ``cache_v`` in place
    (they are returned too).  Returns (out, cache_k, cache_v).
    """
    q, k, v = _decode_qkv(params, x, pos, n_heads=n_heads, n_kv=n_kv,
                          head_dim=head_dim, qkv_bias=qkv_bias,
                          rope_theta=rope_theta, use_rope=use_rope)
    o = _decode_attend(q, k, v, cache_k, cache_v, pos, n_heads=n_heads,
                       head_dim=head_dim, window=window)
    return o @ params["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# Mixture of experts (expert-parallel over a mesh's tensor axis)
# ---------------------------------------------------------------------------

def moe_router(wg: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: [T, D] -> (gates [T, k] float32, softmax over the top k; idx
    [T, k] int64).  The logits are ``x @ wg`` in x's dtype, then float32.
    ``lax.top_k`` puts the lower expert first among equal logits;
    ``torch.topk`` promises no order among ties on CUDA, so a stable
    descending sort gives the reference's."""
    logits = (x @ wg).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), idx[:, :top_k]


def _dispatch(gates, idx, *, top_k: int, capacity: int, e_start: int,
              E_loc: int):
    """The capacity dispatch of the experts ``[e_start, e_start + E_loc)``.

    Assignments are sorted stably by expert (``E_loc`` is the drop bin
    for the experts held elsewhere); an assignment's position within its
    expert comes from ``searchsorted``; those past ``capacity`` are
    dropped, contribute nothing and leave the token's other gates as they
    are.  Returns (keep, buffer slot, flat index, gate) per sorted
    assignment: its flat index is ``t * top_k + j`` for token t's j-th
    choice; a dropped one's slot is ``E_loc * capacity``, the buffer's
    sink row."""
    dev = idx.device
    n = idx.numel()
    flat_e = idx.reshape(-1)
    local = (flat_e >= e_start) & (flat_e < e_start + E_loc)
    loc_e = torch.where(local, flat_e - e_start, E_loc)
    order = torch.argsort(loc_e, stable=True)
    sorted_e = loc_e[order]
    seg_first = torch.searchsorted(sorted_e,
                                   torch.arange(E_loc + 1, device=dev))
    pos_sorted = torch.arange(n, device=dev) - seg_first[sorted_e]
    keep = (pos_sorted < capacity) & (sorted_e < E_loc)
    buf_slot = torch.where(keep, sorted_e * capacity + pos_sorted,
                           E_loc * capacity)
    return keep, buf_slot, order, gates.reshape(-1)[order]


def _grouped(x, keep_f, buf_slot, flat, top_k: int, E_loc: int,
             capacity: int):
    """Token rows of ``x`` [T, d] in the ``[E_loc, capacity, d]`` expert
    buffer (through a sink row for the dropped ones)."""
    x_buf = x.new_zeros((E_loc * capacity + 1, x.shape[1]))
    x_buf[buf_slot] = x[flat // top_k] * keep_f[:, None]
    return x_buf[:-1].reshape(E_loc, capacity, x.shape[1])


def _combine(y, keep_f, buf_slot, flat, gate_sorted, T: int, top_k: int):
    """The experts' outputs ``y`` [E_loc, capacity, D] back to their
    tokens, times their gates: the partial output [T, D], with no atomics.
    Each assignment's gated row goes to its own slot ``flat = t * top_k +
    j`` of a [T, top_k, D] buffer (a dropped or non-local one writes a
    zero row; the slots are distinct, so the write is a plain copy and its
    backward a gather), then each token's rows are added left to right,
    ``((r0 + r1) + r2) ...``, in y's dtype: one result for one input on
    any device."""
    E_loc, capacity, D = y.shape
    y = y.reshape(E_loc * capacity, D)
    y_tok = y[buf_slot.clamp(max=E_loc * capacity - 1)] * keep_f[:, None]
    rows = y.new_empty((T * top_k, D))
    rows[flat] = y_tok * gate_sorted[:, None].to(y.dtype)
    rows = rows.view(T, top_k, D)
    out = rows[:, 0]
    for j in range(1, top_k):
        out = out + rows[:, j]
    return out


def _moe_local_compute(x, gates, idx, w_up, w_gate, w_down, *, top_k: int,
                       capacity: int, activation: str, e_start: int = 0):
    """Dense grouped compute at a fixed capacity for the experts
    ``[e_start, e_start + E_loc)`` that ``w_*`` ([E_loc, ...]) hold.
    x: [T, D]; returns the partial output [T, D]."""
    E_loc = w_up.shape[0]
    keep, buf_slot, flat, gate = _dispatch(
        gates, idx, top_k=top_k, capacity=capacity, e_start=e_start,
        E_loc=E_loc)
    keep_f = keep.to(x.dtype)
    xb = _grouped(x, keep_f, buf_slot, flat, top_k, E_loc, capacity)
    h = torch.bmm(xb, w_up)
    if w_gate is not None:
        h = _act(activation, torch.bmm(xb, w_gate)) * h
    else:
        h = _act(activation, h)
    return _combine(torch.bmm(h, w_down), keep_f, buf_slot, flat, gate,
                    x.shape[0], top_k)


def _moe_local_compute_2d(xg, xg_d, gates, idx, w_up, w_gate, w_down, *,
                          mesh, fsdp_ax, top_k: int, capacity: int,
                          activation: str, e_start: int):
    """2-D-sharded expert compute (decode): the weights keep their (E over
    tensor, D / F over fsdp) slices; the D-contraction partials of the
    up / gate products are summed over fsdp *before* the nonlinearity (one
    all-reduce of both, as the reference's ``psum((h, g))``), and the down
    product contracts this rank's F-slice (a partial the caller sums).

    xg: [T, D] the gathered tokens; xg_d: [T, D_loc] this rank's D-slice.
    Returns the partial output [T, D]."""
    E_loc = w_up.shape[0]
    keep, buf_slot, flat, gate = _dispatch(
        gates, idx, top_k=top_k, capacity=capacity, e_start=e_start,
        E_loc=E_loc)
    keep_f = keep.to(xg.dtype)
    xb = _grouped(xg_d, keep_f, buf_slot, flat, top_k, E_loc, capacity)
    h = torch.bmm(xb, w_up)                           # partial over D
    if w_gate is not None:
        hg = mesh.all_reduce(torch.cat([h, torch.bmm(xb, w_gate)], -1),
                             fsdp_ax, part="moe")
        h, g = hg.split(h.shape[-1], dim=-1)
        h = _act(activation, g) * h
    else:
        h = _act(activation, mesh.all_reduce(h, fsdp_ax, part="moe"))
    f_loc = w_down.shape[1]
    h_f = h.narrow(2, mesh.axis_index(fsdp_ax) * f_loc, f_loc)
    return _combine(torch.bmm(h_f, w_down), keep_f, buf_slot, flat, gate,
                    xg.shape[0], top_k)


def _local_experts(w, mesh, rules, n_experts: int, full: int):
    """This rank's block of an expert leaf [E, X, Y] under the reference's
    ``shard_map`` spec ``P(tensor, fsdp, None)``: experts over the tensor
    axis, dim 1 (D, or F for ``down``; ``full`` its whole size) over fsdp.
    The leaf may arrive as that block (:func:`shard_tree`) or whole
    along a dim whose axis ``param_specs`` dropped (the smoke twins' 8
    experts on 16 production shards), and is then sliced here."""
    n_t = mesh.shape[rules.tensor]
    blocks = [(0, n_experts, n_t, rules.tensor)]
    if rules.fsdp is not None:
        blocks.append((1, full, mesh.shape[rules.fsdp], rules.fsdp))
    for dim, size, n, ax in blocks:
        if size % n:
            raise ValueError(f"an expert leaf's dim {dim} of {size} does not "
                             f"split over {ax!r} of {n}")
        if w.shape[dim] == size and n > 1:
            w = w.narrow(dim, mesh.axis_index(ax) * (size // n), size // n)
        elif w.shape[dim] != size // n:
            raise ValueError(f"an expert leaf of shape {tuple(w.shape)} is "
                             f"neither whole nor this rank's block of dim "
                             f"{dim} over {ax!r} of {n}")
    return w


def _moe_gather_body(xf, gates, idx, w_up, w_gate, w_down, *, mesh,
                     rules: ShardingRules, top_k: int, capacity: int,
                     activation: str, e_start: int) -> torch.Tensor:
    """The gather regime's body on this rank: the expert blocks gathered
    over fsdp, this rank's experts over its tokens, the partials summed
    over the tensor axis (under sequence parallelism they are returned as
    they are: the caller sum-scatters them along the sequence).  Under
    autograd the gathers' backward is a sum-scatter over fsdp and the
    sum's is the identity."""
    if rules.fsdp is not None:
        w_up = mesh.all_gather(w_up, rules.fsdp, dim=1, part="moe")
        w_down = mesh.all_gather(w_down, rules.fsdp, dim=1, part="moe")
        if w_gate is not None:
            w_gate = mesh.all_gather(w_gate, rules.fsdp, dim=1, part="moe")
    out = _moe_local_compute(
        xf, gates, idx, w_up, w_gate, w_down, top_k=top_k,
        capacity=capacity, activation=activation, e_start=e_start)
    if rules.act_seq is not None:
        return out
    return mesh.sum_partials(out, rules.tensor, part="moe")


def _moe_on_mesh(params, xf, gates, idx, *, n_experts: int, top_k: int,
                 capacity_factor: float, activation: str, glu: bool, mesh,
                 rules: ShardingRules) -> torch.Tensor:
    """The reference's ``shard_map`` body, run on this rank: ``xf`` [T_loc,
    D] holds this rank's token rows (all of them when ``rules.batch`` is
    None).  Returns this rank's rows of the output.

    Under sequence parallelism (``rules.act_seq``: train and prefill) the
    rows are the whole sequence of this rank's batch rows, gathered by the
    layer's norm, whose backward (a sum-scatter over the tensor axis) sums
    the tensor ranks' partial cotangents; the output is this rank's
    partial, which ``moe_block`` sum-scatters along the sequence.  It
    trains only so (the train rules'): without sequence parallelism it
    runs forward only.  Under autograd the body runs under a non-reentrant
    checkpoint, as the reference's ``jax.checkpoint``: the backward
    gathers the experts again (ZeRO-3) instead of holding each layer's
    gathered copy, and the recompute issues the same collectives in the
    same order on every rank."""
    weights = [params["up"], params["down"]] + ([params["gate"]] if glu
                                                else [])
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [xf, gates] + weights)
    tensor_ax, fsdp_ax = rules.tensor, rules.fsdp
    batch_axes = rules.batch if isinstance(rules.batch, tuple) else \
        (rules.batch,)
    batch_axes = tuple(a for a in batch_axes if a is not None)
    batch_size = math.prod(mesh.shape[a] for a in batch_axes)
    T_loc, D = xf.shape
    n_shards = mesh.shape[tensor_ax]
    E_loc = n_experts // n_shards
    gather_w = rules.moe_gather_weights or fsdp_ax is None
    if rules.act_seq is not None and not gather_w:
        raise NotImplementedError("moe_block's 2-D (decode) regime runs "
                                  "without sequence parallelism")
    if grad and rules.act_seq is None:
        raise NotImplementedError(
            "moe_block over a mesh without sequence parallelism (the 2-D "
            "decode regime among them) runs forward only: train under "
            "make_rules(kind='train')")
    capacity = max(int((T_loc if gather_w else T_loc * batch_size)
                       * top_k * capacity_factor / n_experts), top_k)
    F_full = params["up"].shape[2]
    w_up = _local_experts(params["up"], mesh, rules, n_experts, D)
    w_down = _local_experts(params["down"], mesh, rules, n_experts, F_full)
    w_gate = (_local_experts(params["gate"], mesh, rules, n_experts, D)
              if glu else None)
    e_start = mesh.axis_index(tensor_ax) * E_loc
    if gather_w:
        # train / prefill: gather the FSDP-sharded expert weights on use
        body = functools.partial(
            _moe_gather_body, mesh=mesh, rules=rules, top_k=top_k,
            capacity=capacity, activation=activation, e_start=e_start)
        if not grad:
            return body(xf, gates, idx, w_up, w_gate, w_down)
        return ckpt.checkpoint(
            body, xf, gates, idx, w_up, w_gate, w_down, use_reentrant=False,
            preserve_rng_state=False)
    # decode: the weights stay 2-D sharded; gather the (few) tokens over
    # the batch axes, sum the partial expert activations
    xg = mesh.all_gather(xf, batch_axes, dim=0, part="moe")
    gg = mesh.all_gather(gates, batch_axes, dim=0, part="moe")
    ig = mesh.all_gather(idx, batch_axes, dim=0, part="moe")
    d_loc = w_up.shape[1]
    xg_d = xg.narrow(1, mesh.axis_index(fsdp_ax) * d_loc, d_loc)
    out = _moe_local_compute_2d(
        xg, xg_d, gg, ig, w_up, w_gate, w_down, mesh=mesh, fsdp_ax=fsdp_ax,
        top_k=top_k, capacity=capacity, activation=activation,
        e_start=e_start)
    # partial over the expert partition (tensor) and the D / F shards
    # (fsdp); pod replicas computed the same work
    out = mesh.all_reduce(out, (tensor_ax, fsdp_ax), part="moe")
    return out.narrow(0, mesh.flat_index(batch_axes) * T_loc, T_loc)


def moe_block(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, activation: str, glu: bool,
              mesh=None, rules: ShardingRules = NO_SHARD) -> torch.Tensor:
    """MoE FFN.  x: [B, S, D].

    With no mesh (or no tensor axis), every expert is computed over its
    ``capacity = max(int(T * k * cf / E), k)`` slots, T = B * S.  Over a
    ``launch.mesh.Mesh``, x holds this rank's batch rows (by
    ``batch_specs``) and the expert leaves are whole or this rank's block
    (``_local_experts``); the experts are split over ``rules.tensor``.
    ``rules.moe_gather_weights`` (train / prefill) all-gathers the leaves
    over ``rules.fsdp``, computes this rank's experts over its own tokens
    at ``capacity = max(int(T_loc * k * cf / E), k)`` and sums over the
    tensor axis; otherwise (decode) it gathers the tokens over the batch
    axes, keeps the weights 2-D sharded (capacity from the global T) and
    sums over (tensor, fsdp).  Over a mesh it trains only under the train
    rules (the gather regime with sequence parallelism, ``_moe_on_mesh``);
    otherwise it runs forward only.  Under sequence parallelism
    (``rules.act_seq``) x holds the whole sequence of the rank's rows (the
    norm's gathered output) and the result is the residual layout: this
    rank's block of the sequence, the partials sum-scattered along it.
    """
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gates, idx = moe_router(params["router"], xf, top_k)
    if mesh is not None and rules.tensor is not None:
        out = _moe_on_mesh(params, xf, gates, idx, n_experts=n_experts,
                           top_k=top_k, capacity_factor=capacity_factor,
                           activation=activation, glu=glu, mesh=mesh,
                           rules=rules)
        out = out.reshape(B, S, D)
        if rules.act_seq is not None:
            out = reduce_out(OnMesh(mesh, rules), out, part="moe")
        return out
    T = B * S
    capacity = max(int(T * top_k * capacity_factor / n_experts), top_k)
    out = _moe_local_compute(
        xf, gates, idx, params["up"], params.get("gate") if glu else None,
        params["down"], top_k=top_k, capacity=capacity,
        activation=activation)
    return out.reshape(B, S, D)


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM
# ---------------------------------------------------------------------------

SCAN_CHUNK = 64     # time steps whose [B, chunk, d_inner, N] terms coexist


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))``, op for op in x's dtype (``F.softplus``
    rounds once and is linear above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via shifted adds.  x: [B, S, C]; w: [K, C]."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[K - 1 - i]
    return out + b


def _ssm_params(params: dict, xc: torch.Tensor, *, d_state: int):
    """Input-dependent dt, B, C.  xc: [B, S, d_inner].  dt is float32 (the
    float32 ``dt_bias`` promotes it)."""
    proj = xc @ params["x_proj"]                  # [B, S, dt_rank + 2N]
    dt_rank = params["dt_proj"].shape[0]
    dt, Bc, Cc = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = softplus(dt @ params["dt_proj"] + params["dt_bias"])
    return dt, Bc, Cc


def _scan_dtype(xc: torch.Tensor, dt: torch.Tensor) -> torch.dtype:
    """The scan's arithmetic dtype: float32, or float64 for float64
    inputs (``gradcheck``)."""
    return torch.promote_types(torch.promote_types(xc.dtype, dt.dtype),
                               torch.float32)


def _chunk_terms(xc, dt, Bc, A, sl: slice, ct: torch.dtype):
    """One chunk's ``dA = exp(dt A)`` and ``dBx = dt x B``, each [B, c,
    di, N] in ``ct``."""
    dtc = dt[:, sl]
    dA = (dtc.to(ct)[..., None] * A).exp_()
    dBx = (dtc * xc[:, sl]).to(ct)[..., None] * Bc[:, sl].to(ct)[..., None, :]
    return dA, dBx


def _scan_forward(xc, dt, Bc, Cc, A_log, chunk: int, starts=None):
    """The recurrence, chunk by chunk: (y [B, S, di] in xc's dtype, h_last
    [B, di, N]); ``starts``, where given, receives each chunk's starting
    state."""
    B, S, di = xc.shape
    ct = _scan_dtype(xc, dt)
    A = -torch.exp(A_log.to(ct))                             # [di, N]
    h = torch.zeros((B, di, A.shape[1]), dtype=ct, device=xc.device)
    ys = []
    for c0, n in trips.each(range(0, S, chunk), lambda c0: min(chunk, S - c0)):
        sl = slice(c0, c0 + chunk)
        if starts is not None:
            starts += [h.clone()] * n
        dA, hs = _chunk_terms(xc, dt, Bc, A, sl, ct)         # dt x B, then h
        for t, _ in trips.each(range(hs.shape[1])):
            h = hs[:, t].addcmul_(dA[:, t], h)
        ys += [torch.einsum("bcdn,bcn->bcd", hs,
                            Cc[:, sl].to(ct)).to(xc.dtype)] * n
    return torch.cat(ys, dim=1), h.contiguous()


class _SelectiveScan(torch.autograd.Function):
    """The scan with the reference's backward: its forward keeps only the
    inputs and each chunk's starting state [B, di, N] (what the
    reference's checkpointed ``chunk_body`` keeps); its backward takes the
    chunks in reverse, recomputes ``dA``, ``dBx`` and the states ``h``,
    runs the reversed recurrence of ``linear_scan``'s custom VJP
    (``g[t] = a[t+1] g[t+1] + dh[t]``, ``da = g h_prev``, ``db = g``,
    ``dh0 = a[0] g[0]``, carried into the chunk before) and chains it
    through ``exp(dt A)``, ``dt x B`` and the ``C`` contraction."""

    @staticmethod
    def forward(ctx, xc, dt, Bc, Cc, A_log, chunk):
        starts: list = []
        y, h = _scan_forward(xc, dt, Bc, Cc, A_log, chunk, starts)
        ctx.save_for_backward(xc, dt, Bc, Cc, A_log, *starts)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        xc, dt, Bc, Cc, A_log, *starts = ctx.saved_tensors
        chunk = ctx.chunk
        ct = _scan_dtype(xc, dt)
        A = -torch.exp(A_log.to(ct))
        gxc, gdt, gB, gC = (torch.empty_like(t) for t in (xc, dt, Bc, Cc))
        gA = torch.zeros_like(A)
        carry = gh.to(ct)                       # dL/dh of the chunk's end
        S = xc.shape[1]
        for k, _ in trips.each(reversed(range(len(starts))),
                               lambda k: min(chunk, S - k * chunk)):
            sl = slice(k * chunk, (k + 1) * chunk)
            dA, hs = _chunk_terms(xc, dt, Bc, A, sl, ct)
            h = starts[k]
            for t, _ in trips.each(range(hs.shape[1])):
                h = hs[:, t].addcmul_(dA[:, t], h)
            Cb, gyb = Cc[:, sl].to(ct), gy[:, sl].to(ct)
            gC[:, sl] = torch.einsum("bcd,bcdn->bcn", gyb, hs)
            g = gyb[..., None] * Cb[:, :, None, :]               # dy/dh
            g[:, -1] += carry
            for t, _ in trips.each(range(g.shape[1] - 2, -1, -1)):
                g[:, t].addcmul_(dA[:, t + 1], g[:, t + 1])
            carry = dA[:, 0] * g[:, 0]
            h_prev = torch.cat([starts[k][:, None], hs[:, :-1]], dim=1)
            gz = (g * h_prev).mul_(dA)                  # d(dt A)
            dtb = dt[:, sl].to(ct)
            gdt_b = torch.einsum("bcdn,dn->bcd", gz, A)
            gA += torch.einsum("bcdn,bcd->dn", gz, dtb)
            gdtx = torch.einsum("bcdn,bcn->bcd", g, Bc[:, sl].to(ct))
            gB[:, sl] = torch.einsum("bcdn,bcd->bcn", g,
                                     (dt[:, sl] * xc[:, sl]).to(ct))
            gdt[:, sl] = gdt_b + gdtx * xc[:, sl].to(ct)
            gxc[:, sl] = gdtx * dtb
        return gxc, gdt, gB, gC, (gA * A).to(A_log.dtype), None


def selective_scan(xc, dt, Bc, Cc, A_log, D_skip, *, chunk: int = SCAN_CHUNK):
    """Selective state-space scan (Mamba-1).

    xc, dt: [B, S, di]; Bc, Cc: [B, S, N]; A_log: [di, N].  Returns (y
    [B, S, di] in xc's dtype, h_last [B, di, N] float32).

    The recurrence ``h[t] = exp(dt[t] A) h[t-1] + dt[t] x[t] B[t]`` runs in
    float32 one time step at a time (one in-place multiply-add a step over
    ``[B, di, N]``), where the reference runs an associative scan within
    chunks of 512; the sums associate differently, within float32
    rounding.  Only ``chunk`` steps' ``[B, chunk, di, N]`` terms are held
    at once (the reference's chunk of 512 would hold 8.6 GB per term at
    falcon-mamba's 32 x 512).  y is cast to xc's dtype before the skip term
    ``(xc * D)`` is added in that dtype.  Where a gradient is wanted the
    scan runs as ``_SelectiveScan``, whose backward is the reference's;
    otherwise (serving) as the plain loop."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dt, Bc, Cc, A_log)):
        y, h = _SelectiveScan.apply(xc, dt, Bc, Cc, A_log, chunk)
    else:
        y, h = _scan_forward(xc, dt, Bc, Cc, A_log, chunk)
    return y + (xc * D_skip).to(xc.dtype), h


def mamba_mixer(params: dict, x: torch.Tensor, *, d_state: int
                ) -> torch.Tensor:
    """Full-sequence Mamba-1 mixer.  x: [B, S, D] -> [B, S, D]."""
    xc, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc = _act("silu", _causal_conv(xc, params["conv_w"], params["conv_b"]))
    dt, Bc, Cc = _ssm_params(params, xc, d_state=d_state)
    y, _ = selective_scan(xc, dt, Bc, Cc, params["A_log"], params["D"])
    return (y * _act("silu", z)) @ params["out_proj"]


def _mamba_step(w: dict, xc: torch.Tensor, z: torch.Tensor,
                conv_state: torch.Tensor, ssm_state: torch.Tensor, *,
                d_state: int, sum_proj=None) -> torch.Tensor:
    """One decode step of the mixer from its input projection ``xc``,
    ``z`` [B, di]: the states updated in place, the gated output [B, di]
    (before ``out_proj``).  ``sum_proj`` finishes ``x_proj``'s product
    (over a mesh, its partials over the channel blocks)."""
    hist = torch.cat([conv_state, xc[:, None]], dim=1)        # [B, K, di]
    conv = torch.einsum("bkd,kd->bd", hist, w["conv_w"]) + w["conv_b"]
    conv_state.copy_(hist[:, 1:])
    xc = _act("silu", conv)
    proj = xc @ w["x_proj"]
    if sum_proj is not None:
        proj = sum_proj(proj)
    dt_rank = w["dt_proj"].shape[0]
    dt, Bc, Cc = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = softplus(dt @ w["dt_proj"] + w["dt_bias"])
    A = -torch.exp(w["A_log"].float())
    dA = torch.exp(dt.float()[..., None] * A)                 # [B, di, N]
    dBx = (dt * xc).float()[..., None] * Bc.float()[:, None, :]
    h = dA * ssm_state + dBx
    ssm_state.copy_(h)
    y = torch.einsum("bdn,bn->bd", h, Cc.float())
    y = (y + xc.float() * w["D"]).to(z.dtype)
    return y * _act("silu", z)


def mamba_decode(params: dict, x: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, *, d_state: int):
    """Single-token Mamba step.  x: [B, 1, D]; conv_state: [B, K-1, di]
    (the last inputs before the conv); ssm_state: [B, di, N] float32.

    Unlike the reference, which returns new states, both states are
    written in place (and returned).  Returns (out [B, 1, D], conv_state,
    ssm_state)."""
    xc, z = (x[:, 0] @ params["in_proj"]).chunk(2, dim=-1)   # [B, di]
    y = _mamba_step(params, xc, z, conv_state, ssm_state, d_state=d_state)
    return (y @ params["out_proj"])[:, None], conv_state, ssm_state


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor, *, scale: bool
          ) -> torch.Tensor:
    x = table[tokens.long()]
    if scale:
        x = x * _const(math.sqrt(table.shape[1]), table.dtype)
    return x.to(table.dtype)


def lm_logits(params: dict, x: torch.Tensor, *, tied: bool) -> torch.Tensor:
    """Logits in float32, the product taken in the activation dtype."""
    w = params["embed"].T if tied else params["lm_head"]
    return (x @ w).float()


# ---------------------------------------------------------------------------
# The layers over a mesh (``params`` this rank's blocks, ``specs`` theirs)
# ---------------------------------------------------------------------------

def mlp_mesh(params: dict, specs: dict, h: torch.Tensor, on: OnMesh, *,
             activation: str, glu: bool) -> torch.Tensor:
    """The MLP over a mesh.  ``h``: the norm's output, whole along the
    sequence and alike on the tensor group.  The D dims are gathered over
    fsdp; ``up`` / ``gate`` columns and ``down`` rows split over the
    tensor axis stay split (column- then row-parallel, the partials summed
    by ``reduce_out``); an F the spec leaves whole is computed whole and
    cut to the residual layout."""
    D = h.shape[-1]
    names = ("up", "down") + (("gate",) if glu else ())
    w = {k: gather_leaf(on, params[k], specs[k], {1 if k == "down" else 0: D})
         for k in names}
    y = mlp(w, h, activation=activation, glu=glu)
    if spec_axes(specs["up"], 1):
        return reduce_out(on, y)
    return seq_own(on, y)


def _head_span(on: OnMesh, spec_wq, n_heads: int, head_dim: int):
    """(first head, heads) of this rank's block of the query columns, or
    None where the spec leaves them whole or a block does not hold whole
    heads (the leaf is then gathered and the heads computed whole)."""
    axes = spec_axes(spec_wq, 1)
    if not axes or -(-n_heads * head_dim // on.n(axes)) % head_dim:
        return None
    start, length = on.span(n_heads * head_dim, axes)
    return start // head_dim, length // head_dim


def _attn_leaves(on: OnMesh, params: dict, specs: dict, D: int, *,
                 n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool,
                 q_whole: bool, o_whole: bool) -> dict:
    """The attention leaves for use: ``wk`` / ``wv`` (and biases) whole;
    ``wq`` / ``bq`` columns and ``wo`` rows whole or this rank's block;
    the D dims gathered over fsdp."""
    Hd, KVd = n_heads * head_dim, n_kv * head_dim
    sizes = {"wq": {0: D, **({1: Hd} if q_whole else {})},
             "wk": {0: D, 1: KVd}, "wv": {0: D, 1: KVd},
             "wo": {**({0: Hd} if o_whole else {}), 1: D}}
    if qkv_bias:
        sizes.update(bq={0: Hd} if q_whole else {}, bk={0: KVd},
                     bv={0: KVd})
    return {k: gather_leaf(on, params[k], specs[k], sz)
            for k, sz in sizes.items()}


def attention_mesh(params: dict, specs: dict, h: torch.Tensor, on: OnMesh,
                   *, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool, rope_theta: float, causal: bool,
                   window: int, positions: torch.Tensor, use_rope: bool,
                   chunk_threshold: int, seq_local: bool = False):
    """Self-attention over a mesh (train / prefill) -> (out in the residual
    layout, k, v [B, S, KV, hd] whole along the sequence, for the cache).

    ``h`` whole along the sequence: the query heads of this rank's
    ``wq`` columns against K and V of every head (``wk`` / ``wv``
    gathered whole), ``wo`` row-parallel and the partials summed; where
    the columns do not hold whole heads, every leaf is gathered and the
    heads computed whole.  ``seq_local`` (``seq_parallel_attn``): ``h`` is
    this rank's block of the sequence, every leaf whole, and only K and V
    are gathered along the sequence."""
    B, S, D = h.shape
    heads = None if seq_local else _head_span(on, specs["wq"], n_heads,
                                              head_dim)
    w = _attn_leaves(on, params, specs, D, n_heads=n_heads, n_kv=n_kv,
                     head_dim=head_dim, qkv_bias=qkv_bias,
                     q_whole=heads is None, o_whole=heads is None)
    s0 = 0
    if seq_local:
        s0 = on.span(positions.shape[0], on.rules.act_seq)[0]
        positions = positions[s0:s0 + S]
    q, k, v = _qkv(w, h, n_heads=heads[1] if heads else n_heads, n_kv=n_kv,
                   head_dim=head_dim, qkv_bias=qkv_bias)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if seq_local:
        k, v = seq_gather(on, k), seq_gather(on, v)
    kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    if heads:
        kf, vf = kf.narrow(2, *heads), vf.narrow(2, *heads)
    if k.shape[1] > chunk_threshold:
        o = chunked_attention(q, kf, vf, causal=causal, window=window,
                              q_offset=s0)
    else:
        o = attention_core(q, kf, vf, causal=causal, window=window,
                           q_offset=s0)
    o = o.reshape(B, S, -1) @ w["wo"]
    if heads:
        o = reduce_out(on, o)
    elif not seq_local:
        o = seq_own(on, o)
    return o, k, v


def project_cross_kv_mesh(params: dict, specs: dict, kv_src: torch.Tensor,
                          on: OnMesh, *, n_kv: int, head_dim: int,
                          qkv_bias: bool):
    """:func:`project_cross_kv` with ``wk`` / ``wv`` gathered whole."""
    D = kv_src.shape[-1]
    KVd = n_kv * head_dim
    w = {k: gather_leaf(on, params[k], specs[k],
                        {0: D, 1: KVd} if k[0] == "w" else {0: KVd})
         for k in ("wk", "wv") + (("bk", "bv") if qkv_bias else ())}
    return project_cross_kv(w, kv_src, n_kv=n_kv, head_dim=head_dim,
                            qkv_bias=qkv_bias)


def cross_attention_mesh(params: dict, specs: dict, h: torch.Tensor, kv_src,
                         on: OnMesh, *, n_heads: int, n_kv: int,
                         head_dim: int, qkv_bias: bool) -> torch.Tensor:
    """Cross-attention over a mesh, split as :func:`attention_mesh`'s
    query heads; the source (or its cached ``(k, v)``) is whole."""
    B, Sq, D = h.shape
    heads = _head_span(on, specs["wq"], n_heads, head_dim)
    w = _attn_leaves(on, params, specs, D, n_heads=n_heads, n_kv=n_kv,
                     head_dim=head_dim, qkv_bias=qkv_bias,
                     q_whole=heads is None, o_whole=heads is None)
    q = h @ w["wq"]
    if qkv_bias:
        q = q + w["bq"]
    q = q.reshape(B, Sq, heads[1] if heads else n_heads, head_dim)
    if isinstance(kv_src, tuple):
        k, v = kv_src
    else:
        k, v = project_cross_kv(w, kv_src, n_kv=n_kv, head_dim=head_dim,
                                qkv_bias=qkv_bias)
    kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
    if heads:
        kf, vf = kf.narrow(2, *heads), vf.narrow(2, *heads)
    o = attention_core(q, kf, vf, causal=False).reshape(B, Sq, -1) @ w["wo"]
    return reduce_out(on, o) if heads else seq_own(on, o)


def decode_attention_mesh(params: dict, specs: dict, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, on: OnMesh, *, n_heads: int, n_kv: int,
                          head_dim: int, qkv_bias: bool, rope_theta: float,
                          window: int, use_rope: bool = True):
    """One-token decode over a mesh.  ``cache_k`` / ``cache_v`` hold this
    rank's block of the positions over ``rules.seq`` (an even split):
    the token's K / V row is written by the rank whose block holds its
    slot; each rank takes every head over its positions (``wq``, ``wk``,
    ``wv`` gathered whole) to a partial max, sum of exponentials and PV
    product, gathered over ``rules.seq`` and combined in rank order
    (:func:`_decode_attend`); ``wo`` is row-parallel, summed over the
    tensor axis.  A seq group of one rank takes
    :func:`decode_self_attention`'s softmax."""
    D = x.shape[-1]
    w = _attn_leaves(on, params, specs, D, n_heads=n_heads, n_kv=n_kv,
                     head_dim=head_dim, qkv_bias=qkv_bias, q_whole=True,
                     o_whole=False)
    q, k, v = _decode_qkv(w, x, pos, n_heads=n_heads, n_kv=n_kv,
                          head_dim=head_dim, qkv_bias=qkv_bias,
                          rope_theta=rope_theta, use_rope=use_rope)
    seq = _axes(on.rules.seq)
    n, L = on.n(seq), cache_k.shape[1]
    o = _decode_attend(
        q, k, v, cache_k, cache_v, pos, n_heads=n_heads, head_dim=head_dim,
        window=window, start=on.mesh.flat_index(seq) * L, S_cache=L * n,
        gather=None if n == 1 else lambda part: on.mesh.all_gather(
            part[None], seq, 0, part="decode_seq"))
    rows = spec_axes(specs["wo"], 0)
    if not rows:
        return o @ w["wo"], cache_k, cache_v
    o = o.narrow(-1, *on.span(n_heads * head_dim, rows)) @ w["wo"]
    return on.mesh.sum_partials(o, rows, part="tp"), cache_k, cache_v


def _mamba_leaves(on: OnMesh, params: dict, specs: dict, D: int,
                  d_inner: int) -> dict:
    """The mixer's leaves for this rank's channel block over the tensor
    axis (``cache_specs`` splits the states the same way): ``in_proj``
    gathered whole (its column block cuts across ``[x | z]``), the
    per-channel leaves and ``x_proj`` / ``out_proj`` rows this rank's
    block, ``out_proj``'s D gathered over fsdp."""
    t = on.rules.tensor

    def loc(k, dim):
        return local_block(on, params[k], specs[k], dim, d_inner, t)
    w = {k: loc(k, dim) for k, dim in (
        ("conv_w", 1), ("conv_b", 0), ("x_proj", 0), ("dt_proj", 1),
        ("dt_bias", 0), ("A_log", 0), ("D", 0))}
    w["in_proj"] = gather_leaf(on, params["in_proj"], specs["in_proj"],
                               {0: D, 1: 2 * d_inner})
    w["out_proj"] = gather_leaf(on, loc("out_proj", 0), specs["out_proj"],
                                {1: D})
    w["channels"] = on.span(d_inner, t)
    return w


def _in_proj(w: dict, h: torch.Tensor, d_inner: int):
    """(xc, z) of this rank's channels; all of them as one product."""
    c0, cl = w["channels"]
    if cl == d_inner:
        return (h @ w["in_proj"]).chunk(2, dim=-1)
    wi = w["in_proj"]
    return h @ wi[:, c0:c0 + cl], h @ wi[:, d_inner + c0:d_inner + c0 + cl]


def mamba_mixer_mesh(params: dict, specs: dict, h: torch.Tensor,
                     on: OnMesh, *, d_state: int, d_inner: int):
    """The Mamba mixer over a mesh -> (out in the residual layout, xc
    before the conv and the last SSM state, both of this rank's
    channels).  ``h`` whole along the sequence (the scan runs over all of
    it); the channels split over the tensor axis need no collective but
    ``x_proj``'s partial dt, B and C, summed before use, and
    ``out_proj``'s row-parallel partials."""
    w = _mamba_leaves(on, params, specs, h.shape[-1], d_inner)
    xc, z = _in_proj(w, h, d_inner)
    xcv = _act("silu", _causal_conv(xc, w["conv_w"], w["conv_b"]))
    # the partials of dt, B and C, summed; each rank reads the sum with its
    # own channels, so under autograd the backward sums as well
    proj, t = xcv @ w["x_proj"], on.rules.tensor
    if torch.is_grad_enabled() and proj.requires_grad:
        proj = on.mesh.enter(on.mesh.sum_partials(proj, t, part="tp"), t,
                             part="tp")
    else:
        proj = on.mesh.all_reduce(proj, t, part="tp")
    dt_rank = w["dt_proj"].shape[0]
    dt, Bc, Cc = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = softplus(dt @ w["dt_proj"] + w["dt_bias"])
    y, h_last = selective_scan(xcv, dt, Bc, Cc, w["A_log"], w["D"])
    out = reduce_out(on, (y * _act("silu", z)) @ w["out_proj"])
    return out, xc, h_last


def mamba_decode_mesh(params: dict, specs: dict, x: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor,
                      on: OnMesh, *, d_state: int, d_inner: int):
    """:func:`mamba_decode` over a mesh, the states this rank's channel
    block (``cache_specs``); ``x_proj``'s and ``out_proj``'s partials
    summed over the tensor axis."""
    w = _mamba_leaves(on, params, specs, x.shape[-1], d_inner)
    xc, z = _in_proj(w, x[:, 0], d_inner)
    t = on.rules.tensor
    y = _mamba_step(w, xc, z, conv_state, ssm_state, d_state=d_state,
                    sum_proj=lambda p: on.mesh.all_reduce(p, t, part="tp"))
    y = on.mesh.sum_partials(y @ w["out_proj"], t, part="tp")
    return y[:, None], conv_state, ssm_state


def embed_mesh(table: torch.Tensor, spec, tokens: torch.Tensor, on: OnMesh,
               *, scale: bool, vocab: int) -> torch.Tensor:
    """The embedding over a mesh, in the residual layout (``tokens`` whole
    along the sequence).  Vocabulary rows split over the tensor axis:
    each rank looks up its rows (the others add zero) and the partials
    are summed (sum-scattered along the sequence under ``sp``)."""
    axes = spec_axes(spec, 0)
    if not axes:
        return seq_own(on, embed(table, tokens, scale=scale))
    if set(axes) != set(_axes(on.rules.tensor)):
        raise ValueError(f"the embedding's rows split over {axes}, not the "
                         f"tensor axis {on.rules.tensor!r}")
    v0, vl = on.span(vocab, axes)
    local = tokens.long() - v0
    own = ((local >= 0) & (local < vl))[..., None]
    if vl:
        x = table[local.clamp(0, vl - 1)] * own.to(table.dtype)
    else:
        x = table.new_zeros(tokens.shape + (table.shape[1],))
    x = reduce_out(on, x, part="vocab")
    if scale:
        x = x * _const(math.sqrt(table.shape[1]), table.dtype)
    return x.to(table.dtype)


def vocab_columns(on: OnMesh, params: dict, specs: dict, D: int, *,
                  tied: bool):
    """The LM head's columns this rank holds, ``[D, V_block]`` (the tied
    embedding's rows transposed, or ``lm_head`` with D gathered over
    fsdp), and the axes splitting the vocabulary (none: whole)."""
    if tied:
        return params["embed"].T, spec_axes(specs["embed"], 0)
    w = gather_leaf(on, params["lm_head"], specs["lm_head"], {0: D})
    return w, spec_axes(specs["lm_head"], 1)


def lm_logits_mesh(params: dict, specs: dict, x: torch.Tensor, on: OnMesh,
                   *, tied: bool, vocab: int) -> torch.Tensor:
    """Logits over a mesh (``x`` alike on the tensor group): this rank's
    vocabulary columns, then gathered whole over their axes."""
    w, axes = vocab_columns(on, params, specs, x.shape[-1], tied=tied)
    logits = (x @ w).float()
    return gather_padded(on.mesh, logits, axes, logits.dim() - 1, vocab,
                         part="vocab")
