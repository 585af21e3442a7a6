"""The port's MoE FFN (``repro_torch.models.layers``: ``moe_router``,
``_moe_local_compute``, ``moe_block``) against the reference's on the CPU,
in float32 within rtol = atol = 1e-4: the router with tied logits, the
dispatch with assignments dropped past capacity and with a share of the
experts held, the block at a capacity that drops and one that does not;
the active parameter count.  The block over a mesh is held in
``test_torch_mesh.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs as PC
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

MOE = ("moonshot-v1-16b-a3b", "arctic-480b")
TOL = dict(rtol=1e-4, atol=1e-4)
T, D, E, FF = 40, 32, 8, 24

_ref_block = jax.jit(RL.moe_block, static_argnames=(
    "n_experts", "top_k", "capacity_factor", "activation", "glu", "mesh"))
_ref_local = jax.jit(RL._moe_local_compute, static_argnames=(
    "n_experts", "top_k", "capacity", "activation", "e_start"))


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _weights(seed, glu=True, d=D, e=E, ff=FF):
    """Router and expert weights, the router's columns 3 and 5 equal (so
    every token's logits tie there)."""
    rng = np.random.default_rng(seed)
    w = {"router": _f32(rng, d, e, scale=d ** -0.5),
         "up": _f32(rng, e, d, ff, scale=d ** -0.5),
         "down": _f32(rng, e, ff, d, scale=ff ** -0.5)}
    if glu:
        w["gate"] = _f32(rng, e, d, ff, scale=d ** -0.5)
    w["router"][:, 5] = w["router"][:, 3]
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _x(seed, *shape):
    x = _f32(np.random.default_rng(seed), *shape)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("top_k", (1, 2, 3))
def test_router_ties_put_the_lower_expert_first(top_k):
    jw, tw = _weights(0)
    jx, tx = _x(1, T, D)
    want_g, want_i = RL.moe_router(jw["router"], jx, top_k)
    got_g, got_i = PL.moe_router(tw["router"], tx, top_k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_g, want_g)
    assert got_g.dtype == torch.float32
    # the tie is real: experts 3 and 5 have equal logits for every token
    logits = (tx @ tw["router"]).numpy()
    np.testing.assert_array_equal(logits[:, 3], logits[:, 5])
    both = (got_i == 3).any(1) & (got_i == 5).any(1)
    if top_k > 1:
        assert bool(both.any())
    for row in got_i[both]:
        assert list(row).index(3) < list(row).index(5)


@pytest.mark.parametrize("capacity", (2, 5, 40))
@pytest.mark.parametrize("held", ("all", "upper half"))
@pytest.mark.parametrize("glu", (True, False))
def test_local_compute_matches_reference(glu, held, capacity):
    """Capacity 2 and 5 of an average 10 assignments an expert drop most
    of them (their gates are not renormalised); 40 drops none.  With the
    upper half of the experts held (``e_start`` 4), assignments to the
    others fall in the drop bin and add nothing."""
    top_k = 2
    jw, tw = _weights(2, glu)
    jx, tx = _x(3, T, D)
    gates, idx = RL.moe_router(jw["router"], jx, top_k)
    lo = 0 if held == "all" else E // 2
    sl = slice(lo, E)
    want = _ref_local(jx, gates, idx, jw["up"][sl],
                      jw["gate"][sl] if glu else None, jw["down"][sl],
                      n_experts=E, top_k=top_k, capacity=capacity,
                      activation="silu", e_start=lo)
    got = PL._moe_local_compute(
        tx, torch.from_numpy(np.array(gates)),
        torch.from_numpy(np.array(idx)).long(), tw["up"][sl],
        tw["gate"][sl] if glu else None, tw["down"][sl], top_k=top_k,
        capacity=capacity, activation="silu", e_start=lo)
    _close(got, want)


@pytest.mark.parametrize("capacity_factor", (0.5, 8.0))
@pytest.mark.parametrize("activation", ("silu", "gelu"))
def test_moe_block_matches_reference(activation, capacity_factor):
    """``moe_block`` on [2, 20, D] with top 2 of 8: capacity 5 (factor
    0.5: most assignments dropped) and 80 (8.0: none)."""
    jw, tw = _weights(4)
    jx, tx = _x(5, 2, T // 2, D)
    kw = dict(n_experts=E, top_k=2, capacity_factor=capacity_factor,
              activation=activation, glu=True)
    want = _ref_block(jw, jx, mesh=None, **kw)
    _close(PL.moe_block(tw, tx, **kw), want)


@pytest.mark.parametrize("arch_id", MOE)
def test_active_param_count(arch_id):
    """Total minus the experts' share not routed to: full width and smoke
    twin, against the reference and the formula."""
    for part in ("model", "smoke"):
        pcfg = getattr(PC.get_arch(arch_id), part)
        got = PT.active_param_count(pcfg)
        assert got == RT.active_param_count(
            getattr(RC.get_arch(arch_id), part))
        n_glu = 3 if pcfg.glu else 2
        experts = (pcfg.num_layers * pcfg.moe_experts * n_glu *
                   pcfg.d_model * pcfg.moe_d_ff)
        assert got == int(PT.param_count(pcfg) - experts +
                          experts * pcfg.moe_top_k / pcfg.moe_experts)
