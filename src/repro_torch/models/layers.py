"""Model-layer primitives of the dense-attention stack (port of
``repro/models/layers.py``: the basic blocks, attention and its decode
path, embedding and the LM head).

Plain functions on tensors, ``(params, x, ...) -> y``, with the reference's
parameter names and layouts (``x @ w`` with ``w`` ``[in, out]``; heads in
``[B, S, H, D]``).  The reference's ``rules`` / ``shard`` arguments are
GSPMD placement hints only and are dropped here.  Attention is written in
plain torch ops (matmul, ``where``, ``softmax``), as the reference writes
it in ``jnp`` outside any Pallas kernel.

Precision follows the reference's order: attention logits in float32 from
the input dtype's q and k (its ``preferred_element_type=float32``),
probabilities cast back to the input dtype before the PV product, norms in
float32, the LM head multiplied in the activation dtype and then cast to
float32, the activations op for op as ``jax.nn`` writes them.  Masked
logits are filled with -1e30, not -inf.

Not ported yet: cross-attention, the MoE block and the Mamba mixer (the
later stage kinds of ``ROADMAP.md`` queue 1 item 5).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

NEG = -1e30


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
