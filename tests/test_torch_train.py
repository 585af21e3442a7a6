"""The port's training path (``repro_torch.train``, ``lm_loss``, the
selective scan's backward) against the reference's on the CPU.

The optimizers' updates from the same grads, params and state (a state
one step in, so the moments are not zero) within 1e-6 abs, AdamW's new
state leaves equal after the cast to the state dtype (Adafactor's factor
means within 1e-6 relative); ``lm_loss`` within
1e-5 relative and every gradient leaf within 1e-4 relative L2 against
``jax.value_and_grad`` of the reference's, for the smoke twins of all
ten architectures (the reference's ``init_params`` carried across with
``interop.params_from``, the cross layers' gates opened, whisper's frames
and llama-vision's patches from the same seed) and for moonshot's twin at
capacity factor 1.0, where assignments drop; one ``train_step`` from the
same params and ``opt_state_from`` state, its params within the
reference's own ``test_microbatch_equals_full_batch`` tolerance (AdamW's
first step is ``±lr`` where a gradient is near 0); microbatches;
gradient compression's error feedback; the scan's backward against
``jax.grad`` of the reference's scan and by ``gradcheck`` in float64.
"""
import dataclasses
import functools

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
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PS
from repro_torch.tree import tree_leaves

ARCHS = RC.ARCH_IDS
B, S = 2, 32

_ref_init = jax.jit(RT.init_params, static_argnums=0)
_ref_loss_grad = jax.jit(jax.value_and_grad(RT.lm_loss, argnums=1),
                         static_argnums=0)
_ref_scan_grad = jax.jit(
    jax.grad(lambda *a, chunk: _scan_objective(RL.selective_scan, jnp,
                                               *a, chunk=chunk),
             argnums=(0, 1, 2, 3, 4, 5)),
    static_argnames=("chunk",))


def _rel_l2(got, want) -> float:
    got = torch.as_tensor(got).double()
    want = torch.from_numpy(np.asarray(want, np.float64))
    den = float(want.norm())
    return float((got - want).norm()) / (den if den > 0 else 1.0)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_tree(seed, scale=1.0):
    """A parameter-shaped tree: a matrix, a stacked [2, 3, 8, 6] leaf, a
    vector, a leaf with a unit dim (unfactored) and a scalar."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (12, 10), "stack": {"k": (2, 3, 8, 6), "b": (2, 3, 6)},
              "v": (7,), "col": (5, 1), "s": ()}
    return jax.tree.map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree))


def _ref_steps(opt, params, grads_seq):
    """The reference's state after one update per grads in ``grads_seq``."""
    state = opt.init(params)
    for i, g in enumerate(grads_seq):
        _, state = opt.update(g, state, params, jnp.int32(i))
    return state


@pytest.mark.parametrize("name,state_dtype", [("adamw", "float32"),
                                              ("adamw", "bfloat16"),
                                              ("adafactor", "float32")])
def test_optimizer_update_matches_reference(name, state_dtype):
    """Step 2 from the state step 1 left (both packages' ``update``, and
    the port's in-place ``apply`` with the same updates)."""
    lr = PO.cosine_schedule(1e-2, warmup=1, total=10)
    rlr = RO.cosine_schedule(1e-2, warmup=1, total=10)
    kw = {"state_dtype": state_dtype} if name == "adamw" else {}
    ropt = getattr(RO, name)(lr=rlr, **kw)
    popt = getattr(PO, name)(lr=lr, **kw)
    params = _opt_tree(0)
    g0, g1 = _opt_tree(1, 3.0), _opt_tree(2, 0.5)
    jp, tp = _both(params)
    state0 = _ref_steps(ropt, jp, [jax.tree.map(jnp.asarray, g0)])
    want_u, want_state = ropt.update(jax.tree.map(jnp.asarray, g1), state0,
                                     jp, jnp.int32(1))
    tg1 = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), g1)
    got_u, got_state = popt.update(
        tg1, interop.opt_state_from(state0, tp, "cpu"), tp, 1)
    for a, b in zip(tree_leaves(got_u), jax.tree.leaves(want_u)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    # AdamW's moments are elementwise: equal after the cast; Adafactor's
    # factors are means, which the packages reduce in another order
    state_tol = dict(rtol=0, atol=0) if name == "adamw" else \
        dict(rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(got_state), jax.tree.leaves(want_state)):
        assert a.dtype == interop._t(np.asarray(b), "cpu").dtype
        np.testing.assert_allclose(interop.to_numpy(a), interop.to_numpy(b),
                                   **state_tol)
    # apply: params plus the same updates, in place
    tp2 = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), params)
    popt.apply(tg1, interop.opt_state_from(state0, tp2, "cpu"), tp2, 1)
    want_p = RO.apply_updates(jp, want_u)
    for a, b in zip(tree_leaves(tp2), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_adafactor_state_is_a_list_in_flattening_order():
    """The factor list follows JAX's leaf order (sorted keys), whatever
    order the dicts were built in."""
    tp = {"z": torch.ones(8, 4), "a": torch.ones(5)}
    st = PO.adafactor().init(tp)
    assert st["f"][0]["v"].shape == (5,)
    assert st["f"][1]["vr"].shape == (8,) and st["f"][1]["vc"].shape == (4,)
    want = RO.adafactor().init({"z": jnp.ones((8, 4)), "a": jnp.ones(5)})
    assert [sorted(d) for d in st["f"]] == [sorted(d) for d in want["f"]]


@pytest.mark.parametrize("scale", (0.01, 10.0))
def test_global_norm_and_clip(scale):
    params = _opt_tree(3, scale)
    jp, tp = _both(params)
    want_g, want_n = RO.clip_by_global_norm(jp, 1.0)
    got_g, got_n = PO.clip_by_global_norm(tp, 1.0)
    np.testing.assert_allclose(float(PO.global_norm(tp)),
                               float(RO.global_norm(jp)), rtol=1e-6)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    for a, b in zip(tree_leaves(got_g), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("step", (0, 5, 10, 55, 100, 130))
def test_cosine_schedule(step):
    """Steps 0, warmup (10), in the warm-up, mid, total (100) and past."""
    got = PO.cosine_schedule(3e-4, warmup=10, total=100)(step)
    want = RO.cosine_schedule(3e-4, warmup=10, total=100)(jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    cross = None
    if cfg.cross_seq:
        cross = rng.standard_normal(
            (B, cfg.cross_seq, cfg.d_model)).astype(np.float32)
    return toks, cross


def _cfgs(arch_id, capacity_factor=None):
    rcfg, pcfg = RC.get_arch(arch_id).smoke, PC.get_arch(arch_id).smoke
    if capacity_factor is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=capacity_factor)
        pcfg = dataclasses.replace(pcfg, capacity_factor=capacity_factor)
    return rcfg, pcfg


def _port_loss_and_grads(pcfg, tp, toks, cross, loss_chunk=1024):
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    loss = PT.lm_loss(pcfg, tp, torch.from_numpy(toks),
                      cross_src=None if cross is None else
                      torch.from_numpy(cross), loss_chunk=loss_chunk)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch_id,capacity_factor",
                         [(a, None) for a in ARCHS] +
                         [("moonshot-v1-16b-a3b", 1.0)])
def test_lm_loss_and_grads_match_reference(arch_id, capacity_factor):
    rcfg, pcfg = _cfgs(arch_id, capacity_factor)
    jp = with_gates(_ref_init(rcfg, jax.random.PRNGKey(0)))
    toks, cross = _inputs(rcfg)
    want, wgrads = _ref_loss_grad(rcfg, jp, jnp.asarray(toks),
                                  cross_src=None if cross is None else
                                  jnp.asarray(cross))
    got, grads = _port_loss_and_grads(pcfg, interop.params_from(jp, "cpu"),
                                      toks, cross)
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))
    for g, w in zip(grads, jax.tree.leaves(wgrads)):
        assert g.shape == w.shape
        assert _rel_l2(g, w) <= 1e-4


def test_capacity_factor_one_drops_assignments():
    """At capacity factor 1.0 moonshot's twin drops assignments (so the
    case above holds the gradients with dropped rows)."""
    rcfg, pcfg = _cfgs("moonshot-v1-16b-a3b", 1.0)
    T = B * S
    capacity = max(int(T * pcfg.moe_top_k * 1.0 / pcfg.moe_experts),
                   pcfg.moe_top_k)
    toks, _ = _inputs(rcfg)
    tp = PT.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    x = PT._embed(pcfg, tp, torch.from_numpy(toks)).reshape(T, -1)
    lp = PT._layer(tp["blocks"][0][0], 0, 0)
    h = PT._norm(lp["ln1"], x, pcfg)
    _, idx = PL.moe_router(lp["moe"]["router"], h, pcfg.moe_top_k)
    per_expert = torch.bincount(idx.reshape(-1),
                                minlength=pcfg.moe_experts)
    assert int(per_expert.max()) > capacity


def test_loss_chunks_sum_to_the_whole():
    """``loss_chunk`` 7 (chunks of 7 and a tail of 3 over S - 1 = 31) gives
    the loss and gradients of one chunk."""
    _, pcfg = _cfgs("qwen2-0.5b")
    toks, _ = _inputs(pcfg, 1)
    tp = PT.init_params(pcfg, torch.Generator().manual_seed(1), "cpu")
    one, g1 = _port_loss_and_grads(pcfg, tp, toks, None)
    many, g7 = _port_loss_and_grads(pcfg, tp, toks, None, loss_chunk=7)
    assert abs(one - many) <= 1e-6 * abs(one)
    for a, b in zip(g1, g7):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch_id", ("qwen2-0.5b", "hymba-1.5b"))
def test_remat_changes_no_gradient(arch_id):
    """The per-layer recompute gives the gradients of the plain
    backward."""
    _, pcfg = _cfgs(arch_id)
    toks, _ = _inputs(pcfg, 2)
    tp = PT.init_params(pcfg, torch.Generator().manual_seed(2), "cpu")
    leaves = tree_leaves(tp)
    w = torch.randn(S, pcfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    out = []
    for remat in (True, False):
        for x in leaves:
            x.requires_grad_(True)
        hidden = PT.forward(pcfg, tp, torch.from_numpy(toks), remat=remat)
        out.append(torch.autograd.grad((hidden * w).sum(), leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_step(arch_id, opt_name, grad_compression=False):
    cfg = RC.get_arch(arch_id).smoke
    opt = RO.make_optimizer(opt_name, lr=1e-3)
    return jax.jit(RS.make_train_step(cfg, opt,
                                      grad_compression=grad_compression))


def _port_step(arch_id, opt_name, **kw):
    cfg = PC.get_arch(arch_id).smoke
    opt = PO.make_optimizer(opt_name, lr=1e-3)
    return opt, PS.make_train_step(cfg, opt, **kw)


@pytest.mark.parametrize("arch_id", ("qwen2-0.5b", "arctic-480b"))
def test_train_step_matches_reference(arch_id):
    """From the params and state one reference step left, one more step in
    each package (AdamW for qwen2's twin, Adafactor for arctic's)."""
    opt_name = RC.get_arch(arch_id).optimizer
    rcfg = RC.get_arch(arch_id).smoke
    ropt = RO.make_optimizer(opt_name, lr=1e-3)
    step = _ref_step(arch_id, opt_name)
    jp = _ref_init(rcfg, jax.random.PRNGKey(3))
    toks, _ = _inputs(rcfg, 3)
    batch = {"tokens": jnp.asarray(toks)}
    jp, js, _ = step(jp, RS.init_opt_state(rcfg, ropt, jp), batch,
                     jnp.int32(0))
    tp = interop.params_from(jp, "cpu")
    ts = interop.opt_state_from(js, tp, "cpu")
    jp, js, jm = step(jp, js, batch, jnp.int32(1))
    _, pstep = _port_step(arch_id, opt_name)
    tp, ts, tm = pstep(tp, ts, {"tokens": torch.from_numpy(toks)}, 1)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-2, atol=2e-3)
    assert int(ts["count"]) == int(js["count"]) == 2


def test_microbatches_equal_full_batch():
    """The reference's ``test_microbatch_equals_full_batch`` on the port:
    2 microbatches against 1 (float32 AdamW state)."""
    cfg = PC.get_arch("qwen2-0.5b").smoke
    opt = PO.adamw(lr=1e-3, state_dtype="float32")
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 16))
        .astype(np.int32))
    outs = {}
    for mb in (1, 2):
        params = PT.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
        step = PS.make_train_step(cfg, opt, microbatches=mb)
        p, _, m = step(params, opt.init(params), {"tokens": toks}, 0)
        outs[mb] = (float(m["loss"]), p)
    np.testing.assert_allclose(outs[1][0], outs[2][0], rtol=1e-4)
    for a, b in zip(tree_leaves(outs[1][1]), tree_leaves(outs[2][1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-2, atol=2e-3)


def test_grad_compression_error_feedback_matches_reference():
    """Three rounds of ``_compress_grads`` on the same grads: the restored
    grads and the carried errors equal the reference's bit for bit."""
    jerr = terr = None
    for i in range(3):
        g = _opt_tree(10 + i, 1.0 + i)
        jg, tg = _both(g)
        if jerr is None:
            jerr = jax.tree.map(jnp.zeros_like, jg)
            terr = jax.tree.map(torch.zeros_like, tg)
        jq, jerr = RS._compress_grads(jg, jerr)
        tq, terr = PS._compress_grads(tg, terr)
        for a, b in zip(tree_leaves(tq) + tree_leaves(terr),
                        jax.tree.leaves(jq) + jax.tree.leaves(jerr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_grad_compression_train_steps_match_reference():
    """Three train steps with compression from the same params: the losses
    within 1e-5 relative, the error feedback finite and in float32."""
    cfg = RC.get_arch("qwen2-0.5b").smoke
    ropt = RO.adamw(lr=1e-3)
    step = _ref_step("qwen2-0.5b", "adamw", grad_compression=True)
    jp = _ref_init(cfg, jax.random.PRNGKey(5))
    tp = interop.params_from(jp, "cpu")
    js = RS.init_opt_state(cfg, ropt, jp, grad_compression=True)
    popt, pstep = _port_step("qwen2-0.5b", "adamw", grad_compression=True)
    ts = PS.init_opt_state(PC.get_arch("qwen2-0.5b").smoke, popt, tp,
                           grad_compression=True)
    toks, _ = _inputs(cfg, 5)
    for i in range(3):
        jp, js, jm = step(jp, js, {"tokens": jnp.asarray(toks)},
                          jnp.int32(i))
        tp, ts, tm = pstep(tp, ts, {"tokens": torch.from_numpy(toks)}, i)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
    errs = tree_leaves(ts["grad_err"])
    assert all(e.dtype == torch.float32 and bool(torch.isfinite(e).all())
               for e in errs)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_decreases_loss(arch_id):
    """The reference's ``test_train_step_decreases_loss`` on the port: 4
    steps on one batch from the port's own init, the arch's optimizer."""
    arch = PC.get_arch(arch_id)
    cfg = arch.smoke
    params = PT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    opt = PO.make_optimizer(arch.optimizer, lr=1e-3)
    opt_state = PS.init_opt_state(cfg, opt, params)
    step_fn = PS.make_train_step(cfg, opt)
    toks, cross = _inputs(cfg, 6)
    batch = {"tokens": torch.from_numpy(toks)}
    if cross is not None:
        batch["cross_src"] = torch.from_numpy(cross)
    losses = []
    for i in range(4):
        params, opt_state, m = step_fn(params, opt_state, batch, i)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the selective scan's backward
# ---------------------------------------------------------------------------

def _scan_objective(scan, xp, xc, dt, Bc, Cc, A_log, D, gy, gh, *, chunk):
    """A scalar whose gradient is the scan's VJP of (gy, gh)."""
    y, h = scan(xc, dt, Bc, Cc, A_log, D, chunk=chunk)
    return xp.sum(y * gy) + xp.sum(h * gh)


def _scan_inputs(seed, b, s, di, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = lambda *sh, scale=1.0: (rng.standard_normal(sh) * scale).astype(dtype)
    dt = np.log1p(np.exp(f(b, s, di) - 1.0)).astype(dtype)     # softplus
    a_log = (np.log(np.arange(1, n + 1, dtype=dtype)) +
             f(di, n, scale=0.1)).astype(dtype)
    return [f(b, s, di), dt, f(b, s, n), f(b, s, n), a_log,
            (1.0 + f(di, scale=0.1)).astype(dtype), f(b, s, di),
            f(b, di, n)]


@pytest.mark.parametrize("chunk", (16, 64))
def test_scan_backward_matches_reference(chunk):
    """S = 45 (no multiple of either chunk): the port's gradients of every
    input, through y and h_last, against ``jax.grad`` of the reference's
    scan at its chunk of 16, within 1e-4 relative L2."""
    arrs = _scan_inputs(0, 2, 45, 24, 8)
    want = _ref_scan_grad(*map(jnp.asarray, arrs), chunk=16)
    ts = [torch.from_numpy(a).requires_grad_(i < 6)
          for i, a in enumerate(arrs)]
    loss = _scan_objective(PL.selective_scan, torch, *ts, chunk=chunk)
    got = torch.autograd.grad(loss, ts[:6])
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= 1e-4


def test_scan_gradcheck():
    """``gradcheck`` in float64 at [1, 7, 3], N 2, chunk 3: chunks of 3, 3
    and a tail of 1."""
    arrs = _scan_inputs(1, 1, 7, 3, 2, np.float64)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs[:6]]

    def fn(*a):
        return PL.selective_scan(*a, chunk=3)
    assert torch.autograd.gradcheck(fn, ts)


def test_scan_forward_under_grad_equals_serving():
    """The autograd Function's forward is the serving loop's, bit for
    bit."""
    arrs = _scan_inputs(2, 2, 45, 24, 8)
    ts = [torch.from_numpy(a) for a in arrs[:6]]
    with torch.inference_mode():
        want = PL.selective_scan(*ts)
    got = PL.selective_scan(ts[0].clone().requires_grad_(), *ts[1:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g.detach(), w, rtol=0, atol=0)
