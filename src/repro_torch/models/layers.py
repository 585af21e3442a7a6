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
reference's; :func:`shard` is the identity, since eager PyTorch has no
compiler to place activations and the reference's constraints change no
value.  The one layer whose values depend on the mesh, ``moe_block``,
runs expert-parallel over a ``launch.mesh.Mesh`` through its
``torch.distributed`` groups (forward only; training over a mesh is
ROADMAP.md queue 1 item 5.7).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

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


def shard(x: torch.Tensor, spec) -> torch.Tensor:
    """The identity: eager PyTorch has no compiler to place activations,
    and the reference's constraint changes no value."""
    return x


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

    def act(self, *rest) -> P | None:
        """Spec for an activation whose leading dim is batch."""
        if self.batch is None and all(r is None for r in rest):
            return None
        return P(self.batch, *rest)

    def residual(self) -> P | None:
        """Spec for the [B, S, D] residual stream at layer boundaries."""
        return self.act(self.act_seq, None)


NO_SHARD = ShardingRules()


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
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (a Python loop where the
    reference scans).  Never materialises [B, H, Sq, Sk]; the peak
    transient is [B, H, Sq, chunk]."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sk <= chunk:
        return attention_core(q, k, v, causal=causal, window=window)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qpos = torch.arange(Sq, device=dev)
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


def self_attention(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                   head_dim: int, qkv_bias: bool, rope_theta: float,
                   causal: bool, window: int, positions: torch.Tensor,
                   use_rope: bool = True, chunk_threshold: int = 2048
                   ) -> torch.Tensor:
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
    B = x.shape[0]
    S_cache = cache_k.shape[1]
    q, k, v = _qkv(params, x, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                   qkv_bias=qkv_bias)
    if use_rope:
        posv = torch.full((1,), pos, device=x.device)
        q = rope(q, posv, rope_theta)
        k = rope(k, posv, rope_theta)
    slot = pos % S_cache if window else pos
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    # validity: slot i holds a position (for a ring: the newest S_cache
    # positions).  The reference's precedence makes the window case
    # ((idx <= pos) & (idx > pos - S_cache)) | (pos >= S_cache).
    idx = torch.arange(S_cache, device=x.device)
    valid = idx <= pos
    if window:
        valid = (valid & (idx > pos - S_cache)) | (pos >= S_cache)
    kf = _repeat_kv(cache_k.to(q.dtype), n_heads)
    vf = _repeat_kv(cache_v.to(q.dtype), n_heads)
    logits = _scores(q, kf) * (1.0 / math.sqrt(head_dim))
    logits = torch.where(valid[None, None, None, :], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = _pv(probs, vf).permute(0, 2, 1, 3).reshape(B, 1, n_heads * head_dim)
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
    are.  Returns (keep, buffer slot, token, gate) per sorted assignment;
    a dropped one's slot is ``E_loc * capacity``, the buffer's sink row."""
    dev = idx.device
    n = idx.numel()
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(idx.shape[0], device=dev).repeat_interleave(top_k)
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
    return keep, buf_slot, flat_t[order], gates.reshape(-1)[order]


def _grouped(x, keep_f, buf_slot, tok_sorted, E_loc: int, capacity: int):
    """Token rows of ``x`` [T, d] in the ``[E_loc, capacity, d]`` expert
    buffer (through a sink row for the dropped ones)."""
    x_buf = x.new_zeros((E_loc * capacity + 1, x.shape[1]))
    x_buf[buf_slot] = x[tok_sorted] * keep_f[:, None]
    return x_buf[:-1].reshape(E_loc, capacity, x.shape[1])


def _combine(y, keep_f, buf_slot, tok_sorted, gate_sorted, T: int):
    """The experts' outputs ``y`` [E_loc, capacity, D] back to their
    tokens, times their gates: the partial output [T, D].  On CUDA
    ``index_add_`` adds a token's k rows with atomics, in an order that
    changes from run to run (so bf16 results do too), unless
    ``torch.use_deterministic_algorithms`` orders it."""
    E_loc, capacity, D = y.shape
    y = y.reshape(E_loc * capacity, D)
    y_tok = y[buf_slot.clamp(max=E_loc * capacity - 1)] * keep_f[:, None]
    out = y.new_zeros((T, D))
    return out.index_add_(0, tok_sorted,
                          y_tok * gate_sorted[:, None].to(y.dtype))


def _moe_local_compute(x, gates, idx, w_up, w_gate, w_down, *, top_k: int,
                       capacity: int, activation: str, e_start: int = 0):
    """Dense grouped compute at a fixed capacity for the experts
    ``[e_start, e_start + E_loc)`` that ``w_*`` ([E_loc, ...]) hold.
    x: [T, D]; returns the partial output [T, D]."""
    E_loc = w_up.shape[0]
    keep, buf_slot, tok, gate = _dispatch(
        gates, idx, top_k=top_k, capacity=capacity, e_start=e_start,
        E_loc=E_loc)
    keep_f = keep.to(x.dtype)
    xb = _grouped(x, keep_f, buf_slot, tok, E_loc, capacity)
    h = torch.bmm(xb, w_up)
    if w_gate is not None:
        h = _act(activation, torch.bmm(xb, w_gate)) * h
    else:
        h = _act(activation, h)
    return _combine(torch.bmm(h, w_down), keep_f, buf_slot, tok, gate,
                    x.shape[0])


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
    keep, buf_slot, tok, gate = _dispatch(
        gates, idx, top_k=top_k, capacity=capacity, e_start=e_start,
        E_loc=E_loc)
    keep_f = keep.to(xg.dtype)
    xb = _grouped(xg_d, keep_f, buf_slot, tok, E_loc, capacity)
    h = torch.bmm(xb, w_up)                           # partial over D
    if w_gate is not None:
        hg = mesh.all_reduce(torch.cat([h, torch.bmm(xb, w_gate)], -1),
                             fsdp_ax)
        h, g = hg.split(h.shape[-1], dim=-1)
        h = _act(activation, g) * h
    else:
        h = _act(activation, mesh.all_reduce(h, fsdp_ax))
    f_loc = w_down.shape[1]
    h_f = h.narrow(2, mesh.axis_index(fsdp_ax) * f_loc, f_loc)
    return _combine(torch.bmm(h_f, w_down), keep_f, buf_slot, tok, gate,
                    xg.shape[0])


def _local_experts(w, mesh, rules, n_experts: int, full: int):
    """This rank's block of an expert leaf [E, X, Y] under the reference's
    ``shard_map`` spec ``P(tensor, fsdp, None)``: experts over the tensor
    axis, dim 1 (D, or F for ``down``; ``full`` its whole size) over fsdp.
    The leaf may arrive as that block (``launch.mesh.shard_tree``) or whole
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


def _moe_on_mesh(params, xf, gates, idx, *, n_experts: int, top_k: int,
                 capacity_factor: float, activation: str, glu: bool, mesh,
                 rules: ShardingRules) -> torch.Tensor:
    """The reference's ``shard_map`` body, run on this rank: ``xf`` [T_loc,
    D] holds this rank's token rows (all of them when ``rules.batch`` is
    None).  Returns this rank's rows of the output."""
    weights = [params["up"], params["down"]] + ([params["gate"]] if glu
                                                else [])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [xf] + weights):
        raise NotImplementedError(
            "moe_block over a mesh runs forward only: training over a mesh "
            "(the expert-parallel backward) is ROADMAP.md queue 1 item 5.7")
    tensor_ax, fsdp_ax = rules.tensor, rules.fsdp
    batch_axes = rules.batch if isinstance(rules.batch, tuple) else \
        (rules.batch,)
    batch_axes = tuple(a for a in batch_axes if a is not None)
    batch_size = math.prod(mesh.shape[a] for a in batch_axes)
    T_loc, D = xf.shape
    n_shards = mesh.shape[tensor_ax]
    E_loc = n_experts // n_shards
    gather_w = rules.moe_gather_weights or fsdp_ax is None
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
        if fsdp_ax is not None:
            w_up = mesh.all_gather(w_up, fsdp_ax, dim=1)
            w_down = mesh.all_gather(w_down, fsdp_ax, dim=1)
            if w_gate is not None:
                w_gate = mesh.all_gather(w_gate, fsdp_ax, dim=1)
        out = _moe_local_compute(
            xf, gates, idx, w_up, w_gate, w_down, top_k=top_k,
            capacity=capacity, activation=activation, e_start=e_start)
        return mesh.all_reduce(out, tensor_ax)
    # decode: the weights stay 2-D sharded; gather the (few) tokens over
    # the batch axes, sum the partial expert activations
    xg = mesh.all_gather(xf, batch_axes, dim=0)
    gg = mesh.all_gather(gates, batch_axes, dim=0)
    ig = mesh.all_gather(idx, batch_axes, dim=0)
    d_loc = w_up.shape[1]
    xg_d = xg.narrow(1, mesh.axis_index(fsdp_ax) * d_loc, d_loc)
    out = _moe_local_compute_2d(
        xg, xg_d, gg, ig, w_up, w_gate, w_down, mesh=mesh, fsdp_ax=fsdp_ax,
        top_k=top_k, capacity=capacity, activation=activation,
        e_start=e_start)
    # partial over the expert partition (tensor) and the D / F shards
    # (fsdp); pod replicas computed the same work
    out = mesh.all_reduce(out, (tensor_ax, fsdp_ax))
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
    sums over (tensor, fsdp).  Forward only over a mesh.
    """
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gates, idx = moe_router(params["router"], xf, top_k)
    if mesh is not None and rules.tensor is not None:
        out = _moe_on_mesh(params, xf, gates, idx, n_experts=n_experts,
                           top_k=top_k, capacity_factor=capacity_factor,
                           activation=activation, glu=glu, mesh=mesh,
                           rules=rules)
        return shard(out.reshape(B, S, D), rules.residual())
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
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        if starts is not None:
            starts.append(h.clone())
        dA, hs = _chunk_terms(xc, dt, Bc, A, sl, ct)         # dt x B, then h
        for t in range(hs.shape[1]):
            h = hs[:, t].addcmul_(dA[:, t], h)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs,
                               Cc[:, sl].to(ct)).to(xc.dtype))
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
        for k in reversed(range(len(starts))):
            sl = slice(k * chunk, (k + 1) * chunk)
            dA, hs = _chunk_terms(xc, dt, Bc, A, sl, ct)
            h = starts[k]
            for t in range(hs.shape[1]):
                h = hs[:, t].addcmul_(dA[:, t], h)
            Cb, gyb = Cc[:, sl].to(ct), gy[:, sl].to(ct)
            gC[:, sl] = torch.einsum("bcd,bcdn->bcn", gyb, hs)
            g = gyb[..., None] * Cb[:, :, None, :]               # dy/dh
            g[:, -1] += carry
            for t in range(g.shape[1] - 2, -1, -1):
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


def mamba_decode(params: dict, x: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, *, d_state: int):
    """Single-token Mamba step.  x: [B, 1, D]; conv_state: [B, K-1, di]
    (the last inputs before the conv); ssm_state: [B, di, N] float32.

    Unlike the reference, which returns new states, both states are
    written in place (and returned).  Returns (out [B, 1, D], conv_state,
    ssm_state)."""
    xc, z = (x[:, 0] @ params["in_proj"]).chunk(2, dim=-1)   # [B, di]
    hist = torch.cat([conv_state, xc[:, None]], dim=1)        # [B, K, di]
    conv = torch.einsum("bkd,kd->bd", hist, params["conv_w"]) + \
        params["conv_b"]
    conv_state.copy_(hist[:, 1:])
    xc = _act("silu", conv)
    proj = xc @ params["x_proj"]
    dt_rank = params["dt_proj"].shape[0]
    dt, Bc, Cc = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = softplus(dt @ params["dt_proj"] + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt.float()[..., None] * A)                 # [B, di, N]
    dBx = (dt * xc).float()[..., None] * Bc.float()[:, None, :]
    h = dA * ssm_state + dBx
    ssm_state.copy_(h)
    y = torch.einsum("bdn,bn->bd", h, Cc.float())
    y = (y + xc.float() * params["D"]).to(x.dtype)
    y = y * _act("silu", z)
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
