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

Not ported yet: the expert-parallel MoE over a mesh
(``_moe_local_compute_2d``; ROADMAP.md queue 1 item 5.5), which raises
``NotImplementedError``.
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
# Mixture of experts (the single-device path)
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


def _moe_local_compute(x, gates, idx, w_up, w_gate, w_down, *, top_k: int,
                       capacity: int, activation: str, e_start: int = 0):
    """Dense grouped compute at a fixed capacity for the experts
    ``[e_start, e_start + E_loc)`` that ``w_*`` ([E_loc, ...]) hold.

    Assignments are sorted stably by expert (``E_loc`` is the drop bin
    for the experts held elsewhere); an assignment's position within its
    expert comes from ``searchsorted``; those past ``capacity`` are
    dropped, contribute nothing and leave the token's other gates as they
    are.  Token rows go into an ``[E_loc * capacity + 1, D]`` buffer whose
    last row is a sink for the dropped ones, and come back through
    ``min(slot, E_loc * capacity - 1)`` times ``keep``.  x: [T, D];
    returns the partial output [T, D]."""
    T, D = x.shape
    E_loc = w_up.shape[0]
    dev = x.device
    flat_e = idx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)
    local = (flat_e >= e_start) & (flat_e < e_start + E_loc)
    loc_e = torch.where(local, flat_e - e_start, E_loc)
    order = torch.argsort(loc_e, stable=True)
    sorted_e = loc_e[order]
    seg_first = torch.searchsorted(sorted_e,
                                   torch.arange(E_loc + 1, device=dev))
    pos_sorted = torch.arange(T * top_k, device=dev) - seg_first[sorted_e]
    keep = (pos_sorted < capacity) & (sorted_e < E_loc)
    keep_f = keep.to(x.dtype)
    buf_slot = torch.where(keep, sorted_e * capacity + pos_sorted,
                           E_loc * capacity)
    tok_sorted = flat_t[order]
    gate_sorted = flat_g[order]
    x_buf = x.new_zeros((E_loc * capacity + 1, D))
    x_buf[buf_slot] = x[tok_sorted] * keep_f[:, None]
    xb = x_buf[:-1].reshape(E_loc, capacity, D)
    h = torch.bmm(xb, w_up)
    if w_gate is not None:
        h = _act(activation, torch.bmm(xb, w_gate)) * h
    else:
        h = _act(activation, h)
    y = torch.bmm(h, w_down).reshape(E_loc * capacity, D)
    y_tok = y[buf_slot.clamp(max=E_loc * capacity - 1)] * keep_f[:, None]
    out = x.new_zeros((T, D))
    return out.index_add_(0, tok_sorted,
                          y_tok * gate_sorted[:, None].to(x.dtype))


def moe_block(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, activation: str, glu: bool,
              mesh=None) -> torch.Tensor:
    """MoE FFN on one device.  x: [B, S, D].  Every expert is computed
    over its ``capacity = max(int(T * k * cf / E), k)`` slots, T = B * S.
    The expert-parallel path over a mesh is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_block over a mesh (the expert-parallel path and "
            "_moe_local_compute_2d) is not ported yet (ROADMAP.md queue 1 "
            "item 5.5)")
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    gates, idx = moe_router(params["router"], xf, top_k)
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
