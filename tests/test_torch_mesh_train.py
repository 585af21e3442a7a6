"""Training over a mesh (``make_grad_fn`` / ``make_train_step`` with
``rules=`` / ``mesh=``, the expert-parallel MoE's backward through the
mesh's collectives, the optimizers' reductions over a mesh, the elastic
restore) against the reference on the CPU, and the MoE's combine.

- Over gloo meshes of 4 ranks (data 2 x model 2, and pod 2 x data 1 x
  model 2; one spawn of 4 ranks per mesh shape runs every case), for the
  moonshot smoke twin (AdamW, moments in float32) and the arctic smoke
  twin (Adafactor), in float32, at capacity factor 1.5, where the batch
  shards drop assignments and the one-device run drops none
  (``test_capacity_factor_drops_only_per_shard``): the loss within 1e-5
  relative of the reference's ``make_loss_fn(cfg, rules=, mesh=)`` under
  ``jax.value_and_grad`` on a JAX mesh of the same shape (4 fake devices,
  in one subprocess), and every rank's gradient leaf within 1e-4
  relative L2 of the reference's leaf cut to that rank's block; two
  ``make_train_step`` steps (and, for moonshot's twin on 2 x 2, one of 2
  microbatches, and the gradients of a one-row batch): the losses, and each rank's parameter and optimizer
  state blocks, within the same grades of the reference's jitted step.
  The reference's ``shard_map`` runs with ``check_vma=False``; its
  gradient is the one-device gradient of the same per-shard function,
  so the port is held to it with no correction.
- ``load(..., sharding=)`` of a checkpoint written on one device equals
  ``shard_tree`` of the whole tree on every rank, each leaf a copy of its
  block.
- The combine: bit-equal in bf16 to the left-to-right sum over each
  token's k rows.
"""
import dataclasses
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_train_worker as W
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import checkpoint as pckpt
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.layers import is_spec
from repro_torch.train.train_step import init_opt_state, make_train_step
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
TWINS = ("moonshot-v1-16b-a3b", "arctic-480b")
B, S, SEED, CF = 4, 16, 2, 1.5
# on the 2 x 2 mesh only: a step of 2 microbatches, and the gradients of
# a global batch of one row (which splits over no batch axis)
MICRO = {"moonshot-v1-16b-a3b": 2}
ONE_ROW = ("moonshot-v1-16b-a3b",)
LOSS_RTOL, LEAF_REL_L2 = 1e-5, 1e-4


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / (den if den > 0 else 1.0)


def _cfg(arch_id):
    return dataclasses.replace(PC.get_arch(arch_id).smoke,
                               capacity_factor=CF)


def _twin_inputs() -> dict:
    """Each twin's weights from the port's seeded init (the reference's
    init is salted per process) and its tokens, as numpy."""
    out = {}
    for arch_id in TWINS:
        cfg = _cfg(arch_id)
        params = PT.init_params(cfg, torch.Generator().manual_seed(SEED),
                                "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=torch.Generator().manual_seed(
                                   100 + SEED))
        out[arch_id] = dict(params=interop.to_numpy(params),
                            tokens=tokens.int().numpy(), cf=CF)
    return out


_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, pickle
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs as C
    from repro.launch import mesh as M
    from repro.models import transformer as T
    from repro.train import optimizer as O
    from repro.train import train_step as S

    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)

    def optimizer(arch_id):
        name = C.get_arch(arch_id).optimizer
        kw = {"state_dtype": "float32"} if name == "adamw" else {}
        return O.make_optimizer(name, lr=1e-3, **kw)

    def leaves(tree):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]

    def setup(mesh, arch_id, t, rows=None):
        cfg = dataclasses.replace(C.get_arch(arch_id).smoke,
                                  capacity_factor=t["cf"])
        tokens = t["tokens"][:rows]
        rules = M.make_rules(mesh, kind="train", global_batch=len(tokens))
        psh = M.named(mesh, T.param_specs(cfg))
        put = lambda: jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a), s), t["params"], psh)
        batch = {"tokens": jnp.asarray(tokens)}
        bsh = M.named(mesh, M.batch_specs(mesh, rules, batch))
        batch = jax.tree.map(jax.device_put, batch, bsh)
        return cfg, rules, psh, put, batch, bsh

    def grads(mesh, arch_id, t, rows=None):
        cfg, rules, psh, put, batch, bsh = setup(mesh, arch_id, t, rows)
        vg = jax.jit(jax.value_and_grad(S.make_loss_fn(cfg, rules=rules,
                                                       mesh=mesh)),
                     in_shardings=(psh, bsh))
        loss, g = vg(put(), batch)
        return {"loss": float(loss), "grads": leaves(g)}

    def twin(mesh, arch_id, t, micro, one_row):
        res = grads(mesh, arch_id, t)
        if one_row:
            res["one_row"] = grads(mesh, arch_id, t, rows=1)
        cfg, rules, psh, put, batch, bsh = setup(mesh, arch_id, t)
        pspecs = T.param_specs(cfg)
        opt = optimizer(arch_id)
        osh = M.named(mesh, opt.init_specs(pspecs, T.param_shapes(cfg)))

        def run(n, microbatches=1):
            step = jax.jit(S.make_train_step(cfg, opt, rules=rules, mesh=mesh,
                                             microbatches=microbatches),
                           in_shardings=(psh, osh, bsh, None),
                           out_shardings=(psh, osh, None))
            params = put()
            state = jax.tree.map(jax.device_put,
                                 S.init_opt_state(cfg, opt, params), osh)
            losses = []
            for i in range(n):
                params, state, m = step(params, state, batch, jnp.int32(i))
                losses.append(float(m["loss"]))
            return losses, leaves(params), leaves(state)
        res["losses"], res["params"], res["state"] = run(2)
        if micro:
            (l,), p, s = run(1, micro)
            res["micro"] = {"loss": l, "params": p, "state": s}
        return res

    out = {}
    for name, (shape, axes) in job["meshes"].items():
        mesh = M.make_mesh(shape, axes)
        with mesh:
            out[name] = {a: twin(mesh, a, t, job["micro"][name].get(a),
                                 a in job["one_row"][name])
                         for a, t in job["twins"].items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _spawn(d: Path, name: str, job: dict):
    """Four gloo ranks on mesh ``name`` through a ``file://`` store."""
    shape, axes = MESHES[name]
    sub = dict(shape=shape, axes=axes, twins=job["twins"],
               ckpt=job["ckpt"], microbatches=job["micro"][name],
               one_row=job["one_row"][name])
    job_file, out = d / f"job_{name}.pkl", d / f"out_{name}"
    with open(job_file, "wb") as f:
        pickle.dump(sub, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run,
                         args=(r, 4, str(d / f"store_{name}"),
                               str(job_file), str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    return procs, out


def _collect(procs, out) -> list:
    for p in procs:
        p.join(timeout=300)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in 300 s"
    assert [p.exitcode for p in procs] == [0] * 4
    res = []
    for r in range(4):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


def _checkpoints(d: Path, twins: dict) -> dict:
    """A checkpoint of each twin written on one device: its weights and
    the optimizer state after one step with no mesh (moments not zero)."""
    out = {}
    for arch_id, t in twins.items():
        cfg = _cfg(arch_id)
        opt = W.optimizer(arch_id)
        params = interop.params_from(t["params"], "cpu")
        state = init_opt_state(cfg, opt, params)
        params, state, _ = make_train_step(cfg, opt)(
            params, state, {"tokens": torch.from_numpy(t["tokens"])}, 0)
        out[arch_id] = str(d / f"ckpt_{arch_id}")
        pckpt.save(out[arch_id], 0, {"params": params, "opt": state})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference in one subprocess (4 fake devices; ``XLA_FLAGS`` set
    there, never here) while each mesh shape's 4 gloo ranks run."""
    d = tmp_path_factory.mktemp("mesh_train")
    twins = _twin_inputs()
    job = dict(meshes=MESHES, twins=twins,
               micro={"2x2": MICRO, "pod2x1x2": {}},
               one_row={"2x2": ONE_ROW, "pod2x1x2": ()},
               ckpt=_checkpoints(d, twins))
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(d / "job.pkl"),
         str(d / "ref.pkl")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = {}
        for name in MESHES:
            ranks[name] = _collect(*_spawn(d, name, job))
        _, err = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(d / "ref.pkl", "rb") as f:
        return ranks, pickle.load(f)


def _cut(x: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    """The block of a whole leaf ``x`` that a rank at ``coords`` holds by
    ``spec`` (``shard_tree``'s ceiling blocks, the flattened index over a
    tuple of axes, the first major)."""
    for dim, ax in enumerate(tuple(spec or ())):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        if not axes:
            continue
        n, flat = 1, 0
        for a in axes:
            flat = flat * sizes[a] + coords[a]
            n *= sizes[a]
        chunk = -(-x.shape[dim] // n)
        x = np.take(x, range(flat * chunk,
                             min((flat + 1) * chunk, x.shape[dim])), dim)
    return x


def _specs(arch_id):
    """The placement's spec leaves of the parameters and of the optimizer
    state (every leaf by ``param_specs``)."""
    cfg = _cfg(arch_id)
    pspecs = PT.param_specs(cfg)
    ospecs = W.optimizer(arch_id).init_specs(pspecs, PT.param_shapes(cfg))
    return (tree_leaves(pspecs, is_leaf=is_spec),
            tree_leaves(ospecs, is_leaf=is_spec))


def _held_to(got: list, want: list, specs: list, coords: dict,
             mesh_name: str) -> None:
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    assert len(got) == len(want) == len(specs) > 0
    for g, w, spec in zip(got, want, specs):
        block = _cut(w, spec, coords, sizes)
        assert g.shape == block.shape
        assert _rel_l2(g, block) <= LEAF_REL_L2


@pytest.mark.parametrize("arch_id", TWINS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_loss_and_grads_over_a_mesh_match_reference(mesh_name, arch_id,
                                                    runs):
    """The loss on every rank, and every rank's gradient blocks, against
    the reference's ``jax.value_and_grad`` on the same mesh; the backward
    issued collectives of its own."""
    ranks, ref = runs
    want = ref[mesh_name][arch_id]
    pspecs, _ = _specs(arch_id)
    for res in ranks[mesh_name]:
        got = res["twins"][arch_id]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"])
        _held_to(got["grads"], want["grads"], pspecs, res["coords"],
                 mesh_name)
        assert got["stats"]["backward_calls"] > 0


@pytest.mark.parametrize("arch_id", TWINS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_train_steps_over_a_mesh_match_reference(mesh_name, arch_id, runs):
    """Two steps: the losses, and each rank's parameter and optimizer
    state blocks (AdamW's global-norm clip; Adafactor's factor means and
    update RMS over split dims)."""
    ranks, ref = runs
    want = ref[mesh_name][arch_id]
    pspecs, ospecs = _specs(arch_id)
    for res in ranks[mesh_name]:
        got = res["twins"][arch_id]
        for g, w in zip(got["losses"], want["losses"]):
            assert abs(g - w) <= LOSS_RTOL * abs(w)
        _held_to(got["params"], want["params"], pspecs, res["coords"],
                 mesh_name)
        _held_to(got["state"], want["state"], ospecs, res["coords"],
                 mesh_name)


def test_microbatches_over_a_mesh_match_reference(runs):
    """One step of 2 microbatches on the 2 x 2 mesh: each rank takes its
    rows of each microbatch as the reference cuts the global batch."""
    ranks, ref = runs
    (arch_id, _), = MICRO.items()
    want = ref["2x2"][arch_id]["micro"]
    pspecs, ospecs = _specs(arch_id)
    for res in ranks["2x2"]:
        got = res["twins"][arch_id]["micro"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"])
        _held_to(got["params"], want["params"], pspecs, res["coords"], "2x2")
        _held_to(got["state"], want["state"], ospecs, res["coords"], "2x2")


def test_grads_of_one_row_over_a_mesh_match_reference(runs):
    """A global batch of one row on the 2 x 2 mesh: no batch axis splits
    it, every rank holds it, and the experts' sum-scatter over ``data``
    adds the same gradient from each ``data`` rank (which the reduction
    scales back)."""
    ranks, ref = runs
    (arch_id,) = ONE_ROW
    want = ref["2x2"][arch_id]["one_row"]
    pspecs, _ = _specs(arch_id)
    for res in ranks["2x2"]:
        got = res["twins"][arch_id]["one_row"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"])
        _held_to(got["grads"], want["grads"], pspecs, res["coords"], "2x2")


@pytest.mark.parametrize("arch_id", TWINS)
@pytest.mark.parametrize("mesh_name", MESHES)
def test_restore_onto_a_mesh_equals_shard_tree(mesh_name, arch_id, runs):
    ranks, _ = runs
    for res in ranks[mesh_name]:
        flags = res["restore"][arch_id]
        assert len(flags) > 10 and all(flags)


def _drops(cfg, params, tokens) -> int:
    """Assignments the forward drops at capacity, over every layer."""
    dropped = []
    orig = PL._dispatch

    def counting(*a, **kw):
        out = orig(*a, **kw)
        dropped.append(int((~out[0]).sum()))
        return out
    PL._dispatch = counting
    try:
        with torch.no_grad():
            PT.forward(cfg, params, tokens)
    finally:
        PL._dispatch = orig
    return sum(dropped)


@pytest.mark.parametrize("arch_id", TWINS)
def test_capacity_factor_drops_only_per_shard(arch_id):
    """At CF the whole batch on one device drops nothing, and each batch
    shard of 2 rows (the capacity counted from its 32 tokens) drops, so
    the cases above hold the per-shard capacity."""
    t = _twin_inputs()[arch_id]
    cfg = _cfg(arch_id)
    params = interop.params_from(t["params"], "cpu")
    tokens = torch.from_numpy(t["tokens"])
    assert _drops(cfg, params, tokens) == 0
    assert _drops(cfg, params, tokens[:2]) + \
        _drops(cfg, params, tokens[2:]) > 0


def test_combine_adds_each_tokens_rows_left_to_right_in_bf16():
    """``_combine`` against the sum over j of each token's k gated rows,
    ``((r0 + r1) + r2) + r3`` in bf16, bit for bit (a dropped assignment
    adds a zero row); the combine's backward is a gather."""
    T_, k, E, C, D = 24, 4, 6, 5, 16
    gen = torch.Generator().manual_seed(7)
    idx = torch.stack([torch.randperm(E, generator=gen)[:k]
                       for _ in range(T_)])
    gates = torch.rand(T_, k, generator=gen)
    keep, buf_slot, flat, gate = PL._dispatch(gates, idx, top_k=k,
                                              capacity=C, e_start=0,
                                              E_loc=E)
    assert not bool(keep.all())                  # some assignments drop
    y = torch.randn(E, C, D, generator=gen).to(torch.bfloat16)
    y.requires_grad_(True)
    got = PL._combine(y, keep.to(y.dtype), buf_slot, flat, gate, T_, k)
    rows = torch.zeros(T_, k, D, dtype=torch.bfloat16)
    yf = y.detach().reshape(E * C, D)
    for s in range(T_ * k):
        if keep[s]:
            t, j = divmod(int(flat[s]), k)
            rows[t, j] = yf[buf_slot[s]] * gate[s].to(torch.bfloat16)
    want = rows[:, 0]
    for j in range(1, k):
        want = want + rows[:, j]
    assert torch.equal(got, want)
    g = torch.randn(T_, D, generator=gen).to(torch.bfloat16)
    (dy,) = torch.autograd.grad(got, y, g)
    want_dy = torch.zeros(E * C, D, dtype=torch.bfloat16)
    for s in range(T_ * k):
        if keep[s]:
            want_dy[buf_slot[s]] = g[int(flat[s]) // k] * \
                gate[s].to(torch.bfloat16)
    assert torch.equal(dy.reshape(E * C, D), want_dy)
