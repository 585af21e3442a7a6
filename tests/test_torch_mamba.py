"""The port's Mamba-1 mixer (``repro_torch.models.layers``) against the
reference's on the CPU, in float32 within rtol = atol = 1e-4: the causal
conv, the input-dependent SSM parameters, the selective scan over a
length that is no multiple of either package's chunk, the mixer, and
decode steps carrying the conv and SSM states; ``softplus`` bit for bit
with ``jax.nn.softplus`` in bfloat16, op by op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import layers as RL
from repro_torch.models import layers as PL

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, D, DI, N, R, K = 2, 45, 32, 48, 8, 6, 4

_ref_scan = jax.jit(RL.selective_scan, static_argnames=("chunk",))
_ref_mixer = jax.jit(RL.mamba_mixer, static_argnames=("d_state",))
_ref_decode = jax.jit(RL.mamba_decode, static_argnames=("d_state",))


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(seed):
    """A mixer's weights at the reference's init scales, with random
    (not constant) conv bias, dt bias, A_log and D."""
    rng = np.random.default_rng(seed)
    w = {"in_proj": _f32(rng, D, 2 * DI, scale=D ** -0.5),
         "conv_w": _f32(rng, K, DI, scale=0.5),
         "conv_b": _f32(rng, DI, scale=0.1),
         "x_proj": _f32(rng, DI, R + 2 * N, scale=DI ** -0.5),
         "dt_proj": _f32(rng, R, DI, scale=R ** -0.5),
         "dt_bias": (-4.0 + _f32(rng, DI)).astype(np.float32),
         "A_log": (np.log(np.arange(1, N + 1, dtype=np.float32)) +
                   _f32(rng, DI, N, scale=0.1)).astype(np.float32),
         "D": (1.0 + _f32(rng, DI, scale=0.1)).astype(np.float32),
         "out_proj": _f32(rng, DI, D, scale=DI ** -0.5)}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _x(seed, *shape):
    x = _f32(np.random.default_rng(seed), *shape)
    return jnp.asarray(x), torch.from_numpy(x)


def test_causal_conv_and_ssm_params():
    jw, tw = _params(0)
    jx, tx = _x(1, B, S, DI)
    _close(PL._causal_conv(tx, tw["conv_w"], tw["conv_b"]),
           RL._causal_conv(jx, jw["conv_w"], jw["conv_b"]))
    for got, want in zip(PL._ssm_params(tw, tx, d_state=N),
                         RL._ssm_params(jw, jx, d_state=N)):
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("chunk", (16, 64))
def test_selective_scan(chunk):
    """S = 45 against the reference at its chunk of 16 (three chunks, the
    last padded) and the port at 16 and 64 (one partial chunk)."""
    jw, tw = _params(2)
    jx, tx = _x(3, B, S, DI)
    jd, td = _x(4, B, S, DI)
    jd, td = jax.nn.softplus(jd), PL.softplus(td)
    jb, tb = _x(5, B, S, N)
    jc, tc = _x(6, B, S, N)
    y, h = _ref_scan(jx, jd, jb, jc, jw["A_log"], jw["D"], chunk=16)
    got_y, got_h = PL.selective_scan(tx, td, tb, tc, tw["A_log"], tw["D"],
                                     chunk=chunk)
    _close(got_y, y)
    _close(got_h, h)
    assert got_h.dtype == torch.float32 and got_h.is_contiguous()


def test_selective_scan_backward_raises():
    """Training through the scan no longer raises (ROADMAP item 5.4 ported
    its backward): a gradient is wanted and every input gets a finite one
    (``test_torch_train.py`` holds them against the reference's)."""
    _, tw = _params(7)
    _, tx = _x(8, B, 4, DI)
    _, tb = _x(9, B, 4, N)
    xc = tx.requires_grad_()
    y, h = PL.selective_scan(xc, tx.abs(), tb, tb, tw["A_log"], tw["D"])
    (g,) = torch.autograd.grad(y.sum() + h.sum(), xc)
    assert g.shape == xc.shape and bool(torch.isfinite(g).all())


def test_mamba_mixer():
    jw, tw = _params(10)
    jx, tx = _x(11, B, S, D)
    _close(PL.mamba_mixer(tw, tx, d_state=N),
           _ref_mixer(jw, jx, d_state=N))


def test_mamba_decode_carries_its_states():
    """Five decode steps from random states, each state written in place
    and equal to the reference's new one."""
    jw, tw = _params(12)
    rng = np.random.default_rng(13)
    conv = _f32(rng, B, K - 1, DI)
    ssm = _f32(rng, B, DI, N)
    jconv, jssm = jnp.asarray(conv), jnp.asarray(ssm)
    tconv, tssm = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    for step in range(5):
        jx, tx = _x(20 + step, B, 1, D)
        out, jconv, jssm = _ref_decode(jw, jx, jconv, jssm, d_state=N)
        got, c, s = PL.mamba_decode(tw, tx, tconv, tssm, d_state=N)
        assert c is tconv and s is tssm
        _close(got, out)
        _close(tconv, jconv)
        _close(tssm, jssm)


def test_softplus_bfloat16_op_for_op():
    """In bfloat16 the port's ``softplus`` equals ``jax.nn.softplus`` run
    op by op (``max(x, 0) + log1p(exp(-|x|))``, each op rounded), over
    negatives, zero, the range past 20 where ``F.softplus`` goes linear,
    and the infinities."""
    x = np.concatenate([np.linspace(-30, 30, 4001, dtype=np.float32),
                        [0.0, -0.0, np.inf, -np.inf]]).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    with jax.disable_jit():
        want = np.asarray(jax.nn.softplus(jx).astype(jnp.float32))
    got = PL.softplus(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
