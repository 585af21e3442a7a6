"""The port's LM (``repro_torch.models``) against the reference
(``repro.models``) on the CPU: the dense layers for the smoke twins of the
four architectures that use only the ``attn`` stage kind, and the whole
model (parameter trees, forward, prefill with every cache leaf, decode)
for the smoke twins of all ten.

Layer tests feed both packages the same numpy inputs and weights (random
norm scales and biases, which the init leaves at ones and zeros); model
tests carry the reference's ``init_params`` across with
``interop.params_from`` (the reference's init is salted per process, so
two inits are never compared), with the cross layers' tanh gates set to
non-zero values in the reference's tree first (at init they are zero and
the layer adds nothing).  Whisper and llama-vision get the same seeded
frames / patches in both packages.  Float32 throughout, within rtol 1e-4
and atol 1e-4, unless a test says otherwise.  The MoE, Mamba and
cross-attention layers have their own files (``test_torch_moe.py``,
``test_torch_mamba.py``, ``test_torch_cross.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import with_gates
from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

DENSE = ("qwen2-0.5b", "qwen1.5-0.5b", "gemma-2b", "gemma3-1b")
ARCHS = RC.ARCH_IDS
B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, **tol):
    torch.testing.assert_close(torch.as_tensor(got),
                               torch.from_numpy(np.array(want)),
                               **(tol or TOL))


# the reference's entry points, jitted once per configuration (eager, each
# of their scans would trace and compile anew at every call)
_ref_init = jax.jit(RT.init_params, static_argnums=0)
_ref_forward = jax.jit(RT.forward, static_argnums=0,
                       static_argnames=("remat",))
_ref_prefill = jax.jit(RT.prefill_step, static_argnums=0,
                       static_argnames=("max_seq",))
_ref_decode = jax.jit(RT.decode_step, static_argnums=0)
_ATTN_STATIC = ("n_heads", "n_kv", "head_dim", "qkv_bias", "rope_theta",
                "use_rope", "window")
_ref_chunked = jax.jit(RL.chunked_attention,
                       static_argnames=("causal", "window", "chunk"))
_ref_self_attention = jax.jit(
    RL.self_attention,
    static_argnames=_ATTN_STATIC + ("causal", "chunk_threshold"))
_ref_decode_attention = jax.jit(RL.decode_self_attention,
                                static_argnames=_ATTN_STATIC)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """A numpy tree as (jax tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _cfgs(arch_id):
    return RC.get_arch(arch_id).smoke, PC.get_arch(arch_id).smoke


_MODELS: dict = {}


def _model(arch_id):
    """(reference cfg, port cfg, reference params, port params), built
    once per module and arch, the cross gates non-zero."""
    if arch_id not in _MODELS:
        rcfg, pcfg = _cfgs(arch_id)
        rp = with_gates(_ref_init(rcfg, jax.random.PRNGKey(0)))
        _MODELS[arch_id] = (rcfg, pcfg, rp, interop.params_from(rp, "cpu"))
    return _MODELS[arch_id]


def _cross(cfg, seed=0, b=B):
    """Seeded frames / patches [b, cross_seq, d_model] as (jax, torch), or
    (None, None) for a model without cross layers."""
    if not cfg.cross_seq:
        return None, None
    x = _f32(_rng(100 + seed), b, cfg.cross_seq, cfg.d_model)
    return jnp.asarray(x), torch.from_numpy(x)


def _tokens(cfg, seed=0, b=B, s=S):
    return _rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _attn_weights(cfg, rng):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    w = {"wq": _f32(rng, D, H * hd, scale=D ** -0.5),
         "wk": _f32(rng, D, KV * hd, scale=D ** -0.5),
         "wv": _f32(rng, D, KV * hd, scale=D ** -0.5),
         "wo": _f32(rng, H * hd, D, scale=(H * hd) ** -0.5)}
    if cfg.qkv_bias:
        w.update(bq=_f32(rng, H * hd), bk=_f32(rng, KV * hd),
                 bv=_f32(rng, KV * hd))
    return w


def _attn_kw(cfg):
    return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
                rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)


def _window(cfg):
    """The configuration's sliding window, else 8."""
    return max(st.window for p in cfg.patterns for st in p.stages) or 8


# ---------------------------------------------------------------------------
# basic blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", DENSE)
def test_norms(arch_id):
    rcfg, _ = _cfgs(arch_id)
    rng = _rng(1)
    x, w = _f32(rng, B, S, rcfg.d_model, scale=3.0), _f32(rng, rcfg.d_model)
    for plus_one in (False, True):
        want = RL.rms_norm(jnp.asarray(w), jnp.asarray(x), rcfg.norm_eps,
                           plus_one=plus_one)
        got = PL.rms_norm(torch.from_numpy(w), torch.from_numpy(x),
                          rcfg.norm_eps, plus_one=plus_one)
        _close(got, want)
    got = PL.apply_norm({"scale": torch.from_numpy(w)}, torch.from_numpy(x),
                        kind=rcfg.norm, eps=rcfg.norm_eps,
                        plus_one=rcfg.norm_plus_one)
    _close(got, RL.apply_norm({"scale": jnp.asarray(w)}, jnp.asarray(x),
                              kind=rcfg.norm, eps=rcfg.norm_eps,
                              plus_one=rcfg.norm_plus_one))
    # the layernorm of whisper (decoder and encoder)
    jw, tw = _both({"scale": w, "bias": _f32(rng, rcfg.d_model)})
    _close(PL.apply_norm(tw, torch.from_numpy(x), kind="layernorm",
                         eps=1e-5),
           RL.apply_norm(jw, jnp.asarray(x), kind="layernorm", eps=1e-5))


@pytest.mark.parametrize("arch_id", DENSE)
def test_rope(arch_id):
    rcfg, _ = _cfgs(arch_id)
    x = _f32(_rng(2), B, S, rcfg.num_heads, rcfg.hd)
    for theta in (rcfg.rope_theta, 1_000_000.0):
        pos = np.arange(5, 5 + S)
        want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        _close(PL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               want)


@pytest.mark.parametrize("arch_id", DENSE)
def test_mlp(arch_id):
    """Gated MLP with the configuration's activation (silu for qwen, the
    tanh gelu for gemma) and, for both, the ungated form."""
    rcfg, _ = _cfgs(arch_id)
    rng = _rng(3)
    D, Fd = rcfg.d_model, rcfg.d_ff
    x = _f32(rng, B, S, D)
    w = {"up": _f32(rng, D, Fd, scale=D ** -0.5),
         "gate": _f32(rng, D, Fd, scale=D ** -0.5),
         "down": _f32(rng, Fd, D, scale=Fd ** -0.5)}
    jw, tw = _both(w)
    for glu in (True, False):
        want = RL.mlp(jw, jnp.asarray(x), activation=rcfg.activation,
                      glu=glu)
        _close(PL.mlp(tw, torch.from_numpy(x), activation=rcfg.activation,
                      glu=glu), want)


@pytest.mark.parametrize("arch_id", DENSE)
def test_embed_and_lm_logits(arch_id):
    rcfg, _ = _cfgs(arch_id)
    rng = _rng(4)
    table = _f32(rng, rcfg.vocab_size, rcfg.d_model)
    toks = _tokens(rcfg, 4)
    for scale in (False, True):
        want = RL.embed(jnp.asarray(table), jnp.asarray(toks), scale=scale)
        _close(PL.embed(torch.from_numpy(table), torch.from_numpy(toks),
                        scale=scale), want)
    x = _f32(rng, B, 3, rcfg.d_model)
    head = _f32(rng, rcfg.d_model, rcfg.vocab_size, scale=0.1)
    jw, tw = _both({"embed": table, "lm_head": head})
    for tied in (True, False):
        want = RL.lm_logits(jw, jnp.asarray(x), tied=tied)
        got = PL.lm_logits(tw, torch.from_numpy(x), tied=tied)
        assert got.dtype == torch.float32
        _close(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("causal", "window"))
@pytest.mark.parametrize("arch_id", DENSE)
def test_attention_core_and_chunked(arch_id, mode):
    """``attention_core`` and ``chunked_attention`` (chunk 8 over 30 keys:
    four chunks, the last padded) against the reference's."""
    rcfg, _ = _cfgs(arch_id)
    rng = _rng(5)
    H, hd, sk = rcfg.num_heads, rcfg.hd, 30
    q, k, v = (_f32(rng, B, sk, H, hd) for _ in range(3))
    window = _window(rcfg) if mode == "window" else 0
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = RL.attention_core(jq, jk, jv, causal=True, window=window)
    _close(PL.attention_core(tq, tk, tv, causal=True, window=window), want)
    want = _ref_chunked(jq, jk, jv, causal=True, window=window,
                                chunk=8)
    got = PL.chunked_attention(tq, tk, tv, causal=True, window=window,
                               chunk=8)
    _close(got, want)
    # masked cache slots and a query offset (the decode-shaped call)
    valid = np.arange(sk) < 20
    want = RL.attention_core(jq[:, :1], jk, jv, causal=True, window=window,
                             q_offset=19, kv_valid=jnp.asarray(valid))
    _close(PL.attention_core(tq[:, :1], tk, tv, causal=True, window=window,
                             q_offset=19, kv_valid=torch.from_numpy(valid)),
           want)


@pytest.mark.parametrize("arch_id", DENSE)
def test_self_attention(arch_id):
    """GQA (qwen2 4 heads over 2 kv, the gemmas' MQA) with QKV bias where
    the configuration has it, plain and chunked (threshold 8)."""
    rcfg, _ = _cfgs(arch_id)
    rng = _rng(6)
    jw, tw = _both(_attn_weights(rcfg, rng))
    x = _f32(rng, B, S, rcfg.d_model)
    pos = np.arange(S)
    for window, thr in ((0, 2048), (_window(rcfg), 2048), (0, 8)):
        want = _ref_self_attention(jw, jnp.asarray(x), causal=True,
                                 window=window, positions=jnp.asarray(pos),
                                 chunk_threshold=thr, **_attn_kw(rcfg))
        got = PL.self_attention(tw, torch.from_numpy(x), causal=True,
                                window=window,
                                positions=torch.from_numpy(pos),
                                chunk_threshold=thr, **_attn_kw(rcfg))
        _close(got, want)


@pytest.mark.parametrize("cache", ("global", "ring"))
@pytest.mark.parametrize("arch_id", DENSE)
def test_decode_self_attention(arch_id, cache):
    """One-token decode against a global cache of 40 slots, or a ring of
    the window's size before it fills, as it wraps and long after."""
    rcfg, _ = _cfgs(arch_id)
    rng = _rng(7)
    KV, hd = rcfg.num_kv_heads, rcfg.hd
    window = _window(rcfg) if cache == "ring" else 0
    slen = window or 40
    jw, tw = _both(_attn_weights(rcfg, rng))
    ck, cv = (_f32(rng, B, slen, KV, hd) for _ in range(2))
    x = _f32(rng, B, 1, rcfg.d_model)
    for pos in ((3, 17, 39) if not window else
                (3, window - 1, window, window + 5, 3 * window + 2)):
        want = _ref_decode_attention(
            jw, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(pos, jnp.int32), window=window, **_attn_kw(rcfg))
        got = PL.decode_self_attention(
            tw, torch.from_numpy(x), torch.from_numpy(ck.copy()),
            torch.from_numpy(cv.copy()), pos, window=window,
            **_attn_kw(rcfg))
        for g, w in zip(got, want):
            _close(g, w)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _same_tree(got, want, **tol):
    g, w = interop.to_numpy(got), interop.to_numpy(want)
    gl, wl = jax.tree.leaves(g), jax.tree.leaves(w)
    assert jax.tree.structure(g) == jax.tree.structure(w)
    for a, b in zip(gl, wl):
        assert a.shape == b.shape
        _close(torch.from_numpy(a), b, **tol)


_STAGE_LEAF = {"attn": "attn.wq", "attn_cross": "xattn.wk",
               "cross": "gate_attn", "mamba": "mixer.A_log",
               "hybrid": "mixer.dt_bias"}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_params_from_keeps_the_tree(arch_id):
    """``params_from`` maps every leaf; ``Transformer`` holds them as
    parameters under the reference's names; ``param_shapes`` has the
    same tree on the meta device; cast to bfloat16, the float32 leaves
    (the SSM's constants, the cross gates) stay float32."""
    rcfg, pcfg, rp, pp = _model(arch_id)
    _same_tree(pp, rp, rtol=0, atol=0)
    model = PT.Transformer(pcfg, pp)
    names = dict(model.named_parameters())
    for j, st in enumerate(pcfg.patterns[0].stages):
        assert f"params.blocks.0.{j}.{_STAGE_LEAF[st.kind]}" in names
    if pcfg.encoder_layers:
        assert "params.encoder.blocks.0.0.attn.wq" in names
    assert sum(t.numel() for t in names.values()) == PT.param_count(pcfg)
    shapes = PT.param_shapes(pcfg)
    assert jax.tree.map(lambda t: tuple(t.shape), shapes) == \
        jax.tree.map(lambda t: tuple(t.shape), pp)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(shapes))
    init = PT.init_params(dataclasses.replace(pcfg, param_dtype="bfloat16"),
                          torch.Generator().manual_seed(0), "cpu")
    half = interop.params_from(rp, "cpu", dtype=torch.bfloat16)
    for tree in (init, half):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, leaf in flat:
            name = path[-1].key
            want = torch.float32 if name in PT.FLOAT32_LEAVES else \
                torch.bfloat16
            assert leaf.dtype == want, (path, leaf.dtype)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_hidden_and_logits(arch_id):
    rcfg, pcfg, rp, pp = _model(arch_id)
    toks = _tokens(rcfg, 8)
    jx, tx = _cross(rcfg, 8)
    rh = _ref_forward(rcfg, rp, jnp.asarray(toks), cross_src=jx,
                      remat=False)
    model = PT.Transformer(pcfg, pp)
    ph = model(torch.from_numpy(toks), tx)
    _close(ph, rh)
    _close(model.logits(ph), RT.logits_from_hidden(rcfg, rp, rh))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_then_teacher_forced_decode(arch_id):
    """``prefill_step`` over 26 tokens into a 32-slot cache (logits and
    every cache leaf: K/V, the cross layers' ``xk`` / ``xv``, the Mamba
    ``conv`` / ``ssm`` states), then 6 teacher-forced ``decode_step``\\ s;
    gemma3's and hymba's 16-slot rings wrap during the prompt and the
    decode."""
    rcfg, pcfg, rp, pp = _model(arch_id)
    toks = _tokens(rcfg, 9)
    jx, tx = _cross(rcfg, 9)
    p0 = S - 6
    rl, rc = _ref_prefill(rcfg, rp, jnp.asarray(toks[:, :p0]), max_seq=S,
                          cross_src=jx)
    pl, pc = PT.prefill_step(pcfg, pp, torch.from_numpy(toks[:, :p0]),
                             max_seq=S, cross_src=tx)
    _close(pl, rl)
    # the zero cache has the filled cache's leaves, shapes and dtypes
    def layout(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                            interop.to_numpy(tree))
    assert layout(PT.init_cache(pcfg, B, S, device="cpu")) == layout(pc) \
        == layout(RT.init_cache(rcfg, B, S))
    _same_tree(pc, rc)
    _same_tree(pc, interop.kv_cache_from(rc, "cpu"))
    for pos in range(p0, S):
        step = toks[:, pos:pos + 1]
        rl, rc = _ref_decode(rcfg, rp, rc, jnp.asarray(step),
                                jnp.asarray(pos, jnp.int32))
        pl, pc = PT.decode_step(pcfg, pp, pc, torch.from_numpy(step), pos)
        assert pl.shape == (B, rcfg.vocab_size) and pl.dtype == torch.float32
        _close(pl, rl)
        _same_tree(pc, rc)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_then_decode_matches_a_longer_prefill(arch_id):
    """The reference test's property (``tests/test_arch_smoke.py:68``),
    made exact: the prefill of ``tokens[:, :S-1]`` and one decode of
    ``tokens[:, S-1]`` at ``pos = S-1`` give the last logits of the
    prefill of ``tokens`` (the MoE smoke twins' capacity factor of 8
    drops no assignment, so both routings compute the same experts)."""
    _, pcfg, _, pp = _model(arch_id)
    toks = torch.from_numpy(_tokens(pcfg, 10))
    _, tx = _cross(pcfg, 10)
    _, cache = PT.prefill_step(pcfg, pp, toks[:, :S - 1], max_seq=S + 4,
                               cross_src=tx)
    got, _ = PT.decode_step(pcfg, pp, cache, toks[:, S - 1:], S - 1)
    want, _ = PT.prefill_step(pcfg, pp, toks, cross_src=tx)
    torch.testing.assert_close(got, want, **TOL)
    assert bool(torch.isfinite(got).all())


def test_bfloat16_serving_matches_reference():
    """qwen2's smoke twin cast to bfloat16 in both packages (the leaves go
    across bit for bit): prefill and 4 teacher-forced decode steps.

    Against the reference run op by op (``jax.disable_jit``: every
    operation rounded to bfloat16 as written) the logits are within a
    relative L2 error of 1e-2 (equal, or nearly).  Compiled, XLA keeps
    excess precision where a bfloat16 result feeds a float32 operation
    (the residual sum into the next norm; its default
    ``xla_allow_excess_precision``), which moves the logits 0.7-0.9% on
    this model; that comparison is held to 2e-2."""
    rcfg, pcfg, rp, _ = _model("qwen2-0.5b")
    rcfg = dataclasses.replace(rcfg, param_dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, param_dtype="bfloat16")
    rp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp)
    pp = interop.params_from(rp, "cpu")
    assert pp["embed"].dtype == torch.bfloat16
    _same_tree(pp, rp, rtol=0, atol=0)
    toks = _tokens(rcfg, 11)
    p0 = S - 4

    def run(prefill, decode, wrap):
        logits, cache = prefill(rcfg, rp, wrap(toks[:, :p0]), max_seq=S)
        out = [logits]
        for pos in range(p0, S):
            logits, cache = decode(rcfg, rp, cache,
                                   wrap(toks[:, pos:pos + 1]),
                                   jnp.asarray(pos, jnp.int32))
            out.append(logits)
        return [np.asarray(o, np.float32) for o in out]

    with jax.disable_jit():
        op_by_op = run(RT.prefill_step, RT.decode_step, jnp.asarray)
    compiled = run(_ref_prefill, _ref_decode, jnp.asarray)
    pl, pc = PT.prefill_step(pcfg, pp, torch.from_numpy(toks[:, :p0]),
                             max_seq=S)
    assert pc[0][0]["k"].dtype == torch.bfloat16
    port = [pl]
    for pos in range(p0, S):
        pl, pc = PT.decode_step(pcfg, pp, pc,
                                torch.from_numpy(toks[:, pos:pos + 1]), pos)
        port.append(pl)
    for step, (got, want, want_c) in enumerate(zip(port, op_by_op,
                                                   compiled)):
        got = got.numpy()
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want), \
            step
        assert np.linalg.norm(got - want_c) <= \
            2e-2 * np.linalg.norm(want_c), step


@pytest.mark.parametrize("arch_id", ("falcon-mamba-7b", "hymba-1.5b"))
def test_bfloat16_mamba_matches_reference_op_by_op(arch_id):
    """The Mamba-bearing smoke twins in bfloat16 (``FLOAT32_LEAVES``
    float32, as the init makes them in both packages): prefill, the cache
    leaves' dtypes, and 4 teacher-forced decode steps, within 1e-2
    relative L2 of the reference run op by op (``jax.disable_jit``).

    The weights are the port's seeded init carried to the reference, so
    the case is the same in every process: over the reference's salted
    inits, an element that rounds to the other side in one bf16 product
    (CPU products accumulate in another order in XLA and in torch) moves
    hymba's logits by 0 to 1e-2 and, rarely, beyond."""
    rcfg, pcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                  for c in _cfgs(arch_id))
    pp = PT.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    rp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), pp)
    toks = _tokens(rcfg, 12)
    p0 = S - 4
    with jax.disable_jit():
        logits, cache = RT.prefill_step(rcfg, rp, jnp.asarray(toks[:, :p0]),
                                        max_seq=S)
        want = [logits]
        for pos in range(p0, S):
            logits, cache = RT.decode_step(
                rcfg, rp, cache, jnp.asarray(toks[:, pos:pos + 1]),
                jnp.asarray(pos, jnp.int32))
            want.append(logits)
    pl, pc = PT.prefill_step(pcfg, pp, torch.from_numpy(toks[:, :p0]),
                             max_seq=S)
    assert pc[0][0]["ssm"].dtype == torch.float32
    assert pc[0][0]["conv"].dtype == torch.bfloat16
    got = [pl]
    for pos in range(p0, S):
        pl, pc = PT.decode_step(pcfg, pp, pc,
                                torch.from_numpy(toks[:, pos:pos + 1]), pos)
        got.append(pl)
    for step, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), step


def test_fill_kv_cache_ring_slots():
    """Prefill rows land where decode reads them: position p at slot
    p % W, for prompts shorter than, equal to and past the ring."""
    for s, max_seq in ((5, 40), (16, 40), (37, 40), (37, 12)):
        k = np.arange(2 * s * 1 * 2, dtype=np.float32).reshape(2, s, 1, 2)
        for window in (0, 16):
            if not window and max_seq < s:
                continue
            want = RT._fill_kv_cache(jnp.asarray(k), window, s, max_seq)
            got = PT._fill_kv_cache(torch.from_numpy(k), window, s, max_seq)
            _close(got, want, rtol=0, atol=0)
