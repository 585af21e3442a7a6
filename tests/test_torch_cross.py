"""The port's cross-attention and encoder against the reference's on the
CPU, in float32 within rtol = atol = 1e-4: ``project_cross_kv`` and
``cross_attention`` (GQA, with and without QKV bias, from the source or
from cached K/V), whisper's ``encode``, and one layer of each cross kind
(``attn_cross``; ``cross`` with non-zero tanh gates, and with the zero
gates of the init, where it adds nothing)."""
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

TOL = dict(rtol=1e-4, atol=1e-4)
B, SQ = 2, 7

_ref_init = jax.jit(RT.init_params, static_argnums=0)
_ref_encode = jax.jit(RT.encode, static_argnums=0)
_ref_layer = jax.jit(RT._layer_fwd, static_argnums=(0, 1),
                     static_argnames=("rules", "mesh"))


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _cfgs(arch_id):
    return RC.get_arch(arch_id).smoke, PC.get_arch(arch_id).smoke


def _xattn_weights(cfg, rng, bias):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    w = {"wq": _f32(rng, D, H * hd, scale=D ** -0.5),
         "wk": _f32(rng, D, KV * hd, scale=D ** -0.5),
         "wv": _f32(rng, D, KV * hd, scale=D ** -0.5),
         "wo": _f32(rng, H * hd, D, scale=(H * hd) ** -0.5)}
    if bias:
        w.update(bq=_f32(rng, H * hd), bk=_f32(rng, KV * hd),
                 bv=_f32(rng, KV * hd))
    return w


@pytest.mark.parametrize("bias", (False, True))
@pytest.mark.parametrize("arch_id", ("llama-3.2-vision-90b",
                                     "whisper-medium"))
def test_cross_attention(arch_id, bias):
    """llama-vision's GQA (4 heads over 2 kv) and whisper's MHA; the
    source projected inside, and the cached (k, v) of
    ``project_cross_kv``."""
    rcfg, _ = _cfgs(arch_id)
    rng = np.random.default_rng(0)
    jw, tw = _both(_xattn_weights(rcfg, rng, bias))
    src = _f32(rng, B, rcfg.cross_seq, rcfg.d_model)
    x = _f32(rng, B, SQ, rcfg.d_model)
    kw = dict(n_heads=rcfg.num_heads, n_kv=rcfg.num_kv_heads,
              head_dim=rcfg.hd, qkv_bias=bias)
    kv_kw = dict(n_kv=rcfg.num_kv_heads, head_dim=rcfg.hd, qkv_bias=bias)
    want_kv = RL.project_cross_kv(jw, jnp.asarray(src), **kv_kw)
    got_kv = PL.project_cross_kv(tw, torch.from_numpy(src), **kv_kw)
    for g, w in zip(got_kv, want_kv):
        assert g.shape == (B, rcfg.cross_seq, rcfg.num_kv_heads, rcfg.hd)
        _close(g, w)
    want = RL.cross_attention(jw, jnp.asarray(x), jnp.asarray(src), **kw)
    _close(PL.cross_attention(tw, torch.from_numpy(x),
                              torch.from_numpy(src), **kw), want)
    _close(PL.cross_attention(tw, torch.from_numpy(x), got_kv, **kw), want)


def test_encode():
    """Whisper's encoder: frames plus learned positions, two
    bidirectional layers without rope (layernorm, tanh gelu, no GLU), the
    final norm; the frames shorter than ``cross_seq`` too."""
    rcfg, pcfg = _cfgs("whisper-medium")
    rp = _ref_init(rcfg, jax.random.PRNGKey(0))
    pp = interop.params_from(rp, "cpu")
    rng = np.random.default_rng(1)
    for se in (rcfg.cross_seq, rcfg.cross_seq - 5):
        frames = _f32(rng, B, se, rcfg.d_model)
        _close(PT.encode(pcfg, pp, torch.from_numpy(frames)),
               _ref_encode(rcfg, rp, jnp.asarray(frames)))


@pytest.mark.parametrize("gates", ((0.7, -0.4), (0.0, 0.0)))
@pytest.mark.parametrize("arch_id,stage", (("llama-3.2-vision-90b", 1),
                                           ("whisper-medium", 0)))
def test_cross_layers(arch_id, stage, gates):
    """One layer of llama-vision's ``cross`` stage and of whisper's
    ``attn_cross`` with random norms (and biases).  Gated at zero, the
    ``cross`` layer returns its input unchanged."""
    rcfg, pcfg = _cfgs(arch_id)
    spec = rcfg.patterns[0].stages[stage]
    rp = with_gates(_ref_init(rcfg, jax.random.PRNGKey(2)), gates)
    rng = np.random.default_rng(3)
    lp = jax.tree.map(lambda a: np.array(a[0, 0]),
                      rp["blocks"][0][stage])
    for norm in ("ln1", "ln2", "lnx"):
        for k in lp.get(norm, {}):
            lp[norm][k] = _f32(rng, *lp[norm][k].shape)
    jlp, tlp = _both(lp)
    x = _f32(rng, B, SQ, rcfg.d_model)
    src = _f32(rng, B, rcfg.cross_seq, rcfg.d_model)
    pos = np.arange(SQ)
    want = _ref_layer(rcfg, spec, jlp, jnp.asarray(x),
                      positions=jnp.asarray(pos),
                      cross_src=jnp.asarray(src), rules=RL.NO_SHARD,
                      mesh=None)
    got = PT._layer_fwd(pcfg, pcfg.patterns[0].stages[stage], tlp, torch.from_numpy(x),
                        positions=torch.from_numpy(pos),
                        cross_src=torch.from_numpy(src))
    _close(got, want)
    if spec.kind == "cross" and gates == (0.0, 0.0):
        torch.testing.assert_close(got, torch.from_numpy(x), rtol=0,
                                   atol=0)
