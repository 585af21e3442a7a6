"""The dense leaves' placement over a mesh (every leaf held as its
``param_specs`` block: FSDP gathers, tensor- and sequence-parallel
attention, MLP, Mamba, embedding and loss, decode caches split over the
sequence) against the reference on the CPU.

- Over gloo meshes of 4 ranks (data 2 x model 2, and pod 2 x data 1 x
  model 2; one spawn of 4 ranks per mesh shape runs every case, while the
  reference runs in two subprocesses on a JAX mesh of data 2 x model 2 (4
  fake devices, ``XLA_FLAGS`` set only there), its steps jitted with the
  dry-run's in_shardings), for eight smoke twins that cover every stage
  kind (qwen2: tied, GQA, qkv bias; gemma3: windowed rings and global
  layers; falcon-mamba; hymba; whisper: the encoder and ``attn_cross``;
  llama-vision: ``cross``, its tanh gates opened; moonshot and arctic:
  the MoE beside dense attention and arctic's dense residual), all in
  float32 from the port's seeded init:

  - prefill and 4 teacher-forced decode steps: each rank's rows of the
    logits at every step and its blocks of the final caches (its block of
    the positions, its Mamba channels) within 1e-4; with the rules'
    sequence-parallel attention and with it flipped; and over one row,
    where decode's sequence spreads over every axis; gemma3 also over
    prompts longer than its window, so that its rings wrap;
  - the loss (within 1e-5 relative) and each rank's gradient blocks
    (within 1e-4 relative L2), both ways of the sequence-parallel
    attention; two train steps (the reference's jitted value and gradient,
    then its optimizer's jitted update): losses, parameter and optimizer
    state blocks, within the same grades (the parameters beside the
    difference of the two runs' last AdamW steps that their moments fix);
  - each rank's parameter bytes equal ``analytical_memory``'s ``params``
    for that mesh, its AdamW (in the architecture's moment dtype) and
    Adafactor state bytes the dry-run's model of them (and its own
    optimizer's ``opt_state``);
  - a gather of ``shard_tree``'s ceiling blocks, short and empty ones
    among them, equals the whole leaf;
  - the collectives of a prefill, a decode step and a train step on rank
    0 equal those ``launch.step_analysis`` counts for the same steps on
    meta tensors through a counting mesh of the same shape, call for
    call and byte for byte, in all, by part, by kind and the backward's
    apart;
  - whisper with a source of 11 frames, which do not split over the
    tensor axis (its 1,500 do not over 16): the loss and every rank's
    gradient blocks against no mesh.
- On a one-rank gloo mesh in this process every twin's serve, loss and
  gradients are bit-equal to no mesh.
"""
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_dense_worker as W
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.launch import mesh as PM
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as PT
from repro_torch.models.layers import is_spec
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import (init_opt_state, make_grad_fn,
                                          make_train_step)
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
TWINS = ("qwen2-0.5b", "gemma3-1b", "falcon-mamba-7b", "hymba-1.5b",
         "whisper-medium", "llama-3.2-vision-90b", "moonshot-v1-16b-a3b",
         "arctic-480b")
B, S, STEPS, TRAIN_S, SEED = 4, 8, 4, 16, 5
# gemma3's prompts that outrun its window of 16: the prefill rolls each
# ring and the decode steps write past its end, to the slots of the oldest
# positions (every slot valid), on the rank whose block holds the slot
WRAP_TWIN, WRAP_S = "gemma3-1b", 20
GATES = (0.7, -0.4)      # the cross layers' tanh gates (zero at init)
# whisper's frames cut so that they do not split over the tensor axis of 2
# (as its 1,500 do not over 16): the encoder's residual in ceiling blocks
UNEVEN_TWIN, UNEVEN_FRAMES = "whisper-medium", 11
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, LEAF_REL_L2 = 1e-5, 1e-4
ADAMW_B1, ADAMW_B2, ADAMW_EPS = 0.9, 0.95, 1e-8


def _open_gates(tree):
    if isinstance(tree, list):
        return [_open_gates(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: _open_gates(v) for k, v in tree.items()}
    for name, g in zip(("gate_attn", "gate_mlp"), GATES):
        if name in out:
            out[name] = np.full_like(out[name], g)
    return out


def _inputs(arch_ids=TWINS) -> dict:
    """Each twin's weights (the port's seeded init, numpy), prompts,
    teacher-forced tokens, cross source and training batch."""
    out = {}
    for i, arch_id in enumerate(TWINS):
        if arch_id not in arch_ids:
            continue
        cfg = PC.get_arch(arch_id).smoke
        params = PT.init_params(cfg, torch.Generator().manual_seed(SEED + i),
                                "cpu")
        rng = np.random.default_rng(60 + i)
        t = dict(params=_open_gates(interop.to_numpy(params)),
                 tokens=rng.integers(0, cfg.vocab_size, (B, S)),
                 next=rng.integers(0, cfg.vocab_size, (B, STEPS)),
                 train_tokens=rng.integers(0, cfg.vocab_size, (B, TRAIN_S)))
        for k in ("tokens", "next", "train_tokens"):
            t[k] = t[k].astype(np.int32)
        if cfg.cross_seq:
            for k in ("cross", "train_cross"):
                t[k] = rng.standard_normal(
                    (B, cfg.cross_seq, cfg.d_model)).astype(np.float32)
        if arch_id == UNEVEN_TWIN:
            t["uneven_frames"] = UNEVEN_FRAMES
        if arch_id == WRAP_TWIN:
            t["wrap_tokens"] = rng.integers(
                0, cfg.vocab_size, (B, WRAP_S)).astype(np.int32)
            t["wrap_next"] = rng.integers(
                0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
        out[arch_id] = t
    return out


_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs as C
    from repro.launch import mesh as M
    from repro.models import transformer as T
    from repro.train import optimizer as O
    from repro.train import train_step as TS
    from repro.train.serve_step import make_decode_step, make_prefill_step

    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)

    def leaves(tree):
        return [np.asarray(x) for x in jax.tree.leaves(tree)]

    def put(tree, sh):
        return jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                            tree, sh)

    def serve(mesh, cfg, t, psh, params, rows, pre=""):
        tokens, nxt = t[pre + "tokens"][:rows], t[pre + "next"][:rows]
        b, s = tokens.shape
        steps = nxt.shape[1]
        rp = M.make_rules(mesh, kind="prefill", global_batch=b, cfg=cfg)
        rd = M.make_rules(mesh, kind="decode", global_batch=b, cfg=cfg)
        data = {"tokens": tokens}
        if "cross" in t:
            data["cross"] = t["cross"][:rows]
        dsh = M.named(mesh, M.batch_specs(mesh, rp, data))
        prefill = make_prefill_step(cfg, rules=rp, mesh=mesh,
                                    max_seq=s + steps)
        fn = jax.jit(lambda p, d: prefill(p, d["tokens"], d.get("cross")),
                     in_shardings=(psh, dsh))
        logits, cache = fn(params, put(data, dsh))
        res = {"prefill": np.asarray(logits), "decode": []}
        step = make_decode_step(cfg, rules=rd, mesh=mesh)
        csh = M.named(mesh, T.cache_specs(cfg, b, s + steps, rd))
        tsh = NamedSharding(mesh, P(rd.batch, None))
        dec = jax.jit(lambda p, c, tok, pos: step(p, c, tok, pos),
                      in_shardings=(psh, csh, tsh, None))
        cache = jax.tree.map(jax.device_put, cache, csh)
        for i in range(steps):
            _, logits, cache = dec(params, cache, jnp.asarray(nxt[:, i:i + 1]),
                                   jnp.int32(s + i))
            res["decode"].append(np.asarray(logits))
        res["cache"] = jax.tree.map(np.asarray, cache)
        return res

    def optimizer(arch_id):
        name = C.get_arch(arch_id).optimizer
        kw = {"state_dtype": "float32"} if name == "adamw" else {}
        return O.make_optimizer(name, lr=1e-3, **kw)

    def twin(mesh, arch_id, t):
        cfg = C.get_arch(arch_id).smoke
        psh = M.named(mesh, T.param_specs(cfg))
        params = put(t["params"], psh)
        res = {"serve": serve(mesh, cfg, t, psh, params, 4)}
        if "wrap_tokens" in t:
            res["serve_wrap"] = serve(mesh, cfg, t, psh, params, 4, "wrap_")
        batch = {"tokens": t["train_tokens"]}
        if "train_cross" in t:
            batch["cross_src"] = t["train_cross"]
        rules = M.make_rules(mesh, kind="train",
                             global_batch=len(batch["tokens"]), cfg=cfg)
        bsh = M.named(mesh, M.batch_specs(mesh, rules, batch))
        batch = put(batch, bsh)
        vg = jax.jit(jax.value_and_grad(TS.make_loss_fn(cfg, rules=rules,
                                                        mesh=mesh)),
                     in_shardings=(psh, bsh))
        loss, g = vg(params, batch)
        res["loss"], res["grads"] = float(loss), leaves(g)
        # the train step's body (make_train_step): the jitted value and
        # gradient above, then the optimizer's update and apply, jitted
        opt = optimizer(arch_id)
        osh = M.named(mesh, opt.init_specs(T.param_specs(cfg),
                                           T.param_shapes(cfg)))

        def update(p, state, g, i):
            u, state = opt.update(g, state, p, i)
            return O.apply_updates(p, u), state
        upd = jax.jit(update, in_shardings=(psh, osh, psh, None),
                      out_shardings=(psh, osh))
        p = put(t["params"], psh)
        state = jax.tree.map(jax.device_put,
                             TS.init_opt_state(cfg, opt, p), osh)
        losses = []
        for i in range(2):
            loss, g = vg(p, batch)
            g = jax.tree.map(jax.device_put, g, psh)
            p, state = upd(p, state, g, jnp.int32(i))
            losses.append(float(loss))
        res["losses"], res["params"], res["state"] = (losses, leaves(p),
                                                     leaves(state))
        return res

    mesh = M.make_mesh((2, 2), ("data", "model"))
    with mesh:
        out = {a: twin(mesh, a, t) for a, t in job["twins"].items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _spawn(d: Path, name: str, twins: dict):
    shape, axes = MESHES[name]
    job_file, out = d / f"job_{name}.pkl", d / f"out_{name}"
    with open(job_file, "wb") as f:
        pickle.dump(dict(shape=shape, axes=axes, twins=twins), f)
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
        p.join(timeout=600)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish in 600 s"
    assert [p.exitcode for p in procs] == [0] * 4
    res = []
    for r in range(4):
        with open(f"{out}.{r}", "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference in two subprocesses (half the twins each) while each
    mesh shape's 4 gloo ranks run, one mesh shape at a time."""
    d = tmp_path_factory.mktemp("mesh_dense")
    twins = _inputs()
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    refs = []
    for h, names in enumerate((TWINS[::2], TWINS[1::2])):
        with open(d / f"job{h}.pkl", "wb") as f:
            pickle.dump({"twins": {a: twins[a] for a in names}}, f)
        refs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, str(d / f"job{h}.pkl"),
             str(d / f"ref{h}.pkl")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ranks = {name: _collect(*_spawn(d, name, twins)) for name in MESHES}
        errs = [ref.communicate(timeout=900)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    want = {}
    for h, (ref, err) in enumerate(zip(refs, errs)):
        assert ref.returncode == 0, err[-3000:]
        with open(d / f"ref{h}.pkl", "rb") as f:
            want.update(pickle.load(f))
    return ranks, want, twins


def _cut(x: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    """The block of a whole leaf ``x`` that a rank at ``coords`` holds by
    ``spec`` (``shard_tree``'s ceiling blocks)."""
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


def _sizes(mesh_name) -> dict:
    shape, axes = MESHES[mesh_name]
    return dict(zip(axes, shape))


def _rows(coords: dict, mesh_name: str, n: int) -> slice:
    """The global rows a rank holds of ``n`` batch rows (all of them when
    they fill no batch axis)."""
    sizes = _sizes(mesh_name)
    k = sizes.get("pod", 1) * sizes["data"]
    if n < k:
        return slice(0, n)
    flat = coords.get("pod", 0) * sizes["data"] + coords["data"]
    return slice(flat * n // k, (flat + 1) * n // k)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / (den if den > 0 else 1.0)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _spec_leaves(tree) -> list:
    return tree_leaves(tree, is_leaf=is_spec)


CASES = [(m, a) for m in MESHES for a in TWINS]
IDS = [f"{m}-{a}" for m, a in CASES]


def _serve_held_to(res: dict, got: dict, want: dict, mesh_name: str, cfg,
                   n: int, prompt_len: int) -> None:
    """A rank's serve of ``n`` rows against the reference's of four: its
    rows of the logits at every step, and its blocks of the final caches
    (``cache_specs`` under the decode rules: its block of the positions,
    its Mamba channels).  One row is held to the reference's first: no
    row's result depends on another's (the MoE twins' capacity drops
    nothing)."""
    coords = res["coords"]
    rows = _rows(coords, mesh_name, n) if n > 1 else slice(0, 1)
    _close(got["prefill"], want["prefill"][rows])
    assert len(got["decode"]) == STEPS
    for g, w in zip(got["decode"], want["decode"]):
        _close(g, w[rows])
    rd = PM.make_rules(PM.Mesh(_sizes(mesh_name), virtual=True),
                       kind="decode", global_batch=n, cfg=cfg)
    specs = _spec_leaves(PT.cache_specs(
        cfg, n, prompt_len + STEPS, PM.ShardingRules(seq=rd.seq)))
    g_leaves = jax.tree.leaves(got["cache"])
    w_leaves = jax.tree.leaves(want["cache"])
    assert len(g_leaves) == len(w_leaves) == len(specs) > 0
    for g, w, spec in zip(g_leaves, w_leaves, specs):
        block = _cut(w[:, :, rows], spec, coords, _sizes(mesh_name))
        assert g.shape == block.shape
        _close(g, block)


@pytest.mark.parametrize("what", ("serve", "serve_flip", "serve_one"))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_serve_over_a_mesh_matches_reference(case, what, runs):
    """Prefill and 4 decode steps (``_serve_held_to``), with the rules'
    sequence-parallel attention, with it flipped, and over one row
    (decode's sequence over every axis)."""
    mesh_name, arch_id = case
    ranks, ref, _ = runs
    cfg = PC.get_arch(arch_id).smoke
    for res in ranks[mesh_name]:
        _serve_held_to(res, res["twins"][arch_id][what], ref[arch_id]["serve"],
                       mesh_name, cfg, 1 if what == "serve_one" else B, S)


@pytest.mark.parametrize("rows", (B, 1), ids=("rows4", "rows1"))
@pytest.mark.parametrize("mesh_name", MESHES)
def test_windowed_ring_wraps_over_a_mesh(mesh_name, rows, runs):
    """gemma3 over prompts that outrun its window: prefill and 4 decode
    steps past the ring's end held to the reference
    (``_serve_held_to``), its window's ring split over the model axis
    (four rows) and over every axis (one row)."""
    ranks, ref, _ = runs
    cfg = PC.get_arch(WRAP_TWIN).smoke
    windows = {st.window for pat in cfg.patterns for st in pat.stages}
    assert 0 < max(windows) < WRAP_S     # the prompt alone outruns it
    for res in ranks[mesh_name]:
        got = res["twins"][WRAP_TWIN]["serve_wrap" if rows > 1 else
                                      "serve_wrap_one"]
        _serve_held_to(res, got, ref[WRAP_TWIN]["serve_wrap"], mesh_name,
                       cfg, rows, WRAP_S)


def _held_to(got: list, want: list, specs: list, coords: dict,
             mesh_name: str) -> None:
    assert len(got) == len(want) == len(specs) > 0
    for g, w, spec in zip(got, want, specs):
        block = _cut(w, spec, coords, _sizes(mesh_name))
        assert g.shape == block.shape
        assert _rel_l2(g, block) <= LEAF_REL_L2


@pytest.mark.parametrize("what", ("grads", "grads_flip"))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_and_grads_over_a_mesh_match_reference(case, what, runs):
    """The loss on every rank and every rank's gradient blocks (by
    ``param_specs``), with the train rules' sequence-parallel attention
    and with it flipped; the backward issued collectives of its own."""
    mesh_name, arch_id = case
    ranks, ref, _ = runs
    want = ref[arch_id]
    specs = _spec_leaves(PT.param_specs(PC.get_arch(arch_id).smoke))
    for res in ranks[mesh_name]:
        got = res["twins"][arch_id][what]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"])
        _held_to(got["grads"], want["grads"], specs, res["coords"],
                 mesh_name)
        assert got["stats"]["backward_calls"] > 0


def _adamw_step(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """AdamW's step direction after two steps, from its moments (the
    twins' AdamW: ``optimizer.adamw``'s betas and epsilon)."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - ADAMW_B1 ** 2)) / (np.sqrt(v / (1 - ADAMW_B2 ** 2)) +
                                        ADAMW_EPS)


def _moments(state: list, ospecs) -> tuple[list, list]:
    """AdamW's first and second moment leaves of a state's leaves, each
    in the parameters' leaf order."""
    paths = [p for p, _ in tree_flatten_with_path(ospecs, is_leaf=is_spec)]
    assert len(paths) == len(state)
    return ([x for p, x in zip(paths, state) if p[0] == "m"],
            [x for p, x in zip(paths, state) if p[0] == "v"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_train_steps_over_a_mesh_match_reference(case, runs):
    """Two steps of the twin's optimizer: the losses, each rank's
    optimizer state blocks within LEAF_REL_L2 of the reference's, and its
    parameter blocks within LEAF_REL_L2 of the reference's moved by the
    difference between the two runs' second AdamW steps, which their
    moments (held above) fix.  AdamW divides the first moment by the root
    of the second, so where an element's gradients nearly cancel over the
    two steps (in qwen2's key bias, at a few 1e-6 against the leaf's
    1e-1) the moments' rounding, within their grade, moves the parameter
    by up to a few 1e-6 against values of 1e-3: more than 1e-4 of the
    leaf.  An update that is skipped or misplaced still fails: the
    moments then agree and the parameters do not."""
    mesh_name, arch_id = case
    ranks, ref, _ = runs
    want = ref[arch_id]
    cfg = PC.get_arch(arch_id).smoke
    pspecs = _spec_leaves(PT.param_specs(cfg))
    ospecs = W.optimizer(arch_id).init_specs(PT.param_specs(cfg),
                                             PT.param_shapes(cfg))
    adamw = PC.get_arch(arch_id).optimizer == "adamw"
    sizes = _sizes(mesh_name)
    for res in ranks[mesh_name]:
        got, coords = res["twins"][arch_id]["steps"], res["coords"]
        for g, w in zip(got["losses"], want["losses"]):
            assert abs(g - w) <= LOSS_RTOL * abs(w)
        _held_to(got["state"], want["state"], _spec_leaves(ospecs), coords,
                 mesh_name)
        wp = [_cut(w, sp, coords, sizes)
              for w, sp in zip(want["params"], pspecs)]
        if adamw:
            gm, gv = _moments(got["state"], ospecs)
            wm, wv = _moments(want["state"], ospecs)
            wp = [w - W.LR * (_adamw_step(m, v) - _adamw_step(
                _cut(m0, sp, coords, sizes), _cut(v0, sp, coords, sizes)))
                for w, m, v, m0, v0, sp in zip(wp, gm, gv, wm, wv, pspecs)]
        assert len(got["params"]) == len(wp) > 0
        for g, w in zip(got["params"], wp):
            assert g.shape == w.shape
            assert _rel_l2(g, w) <= LEAF_REL_L2


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rank_bytes_equal_the_memory_model(case, runs):
    """Each rank holds the parameter and optimizer state bytes that the
    dry-run's memory model states for its mesh."""
    mesh_name, arch_id = case
    ranks, _, _ = runs
    for res in ranks[mesh_name]:
        mem = res["twins"][arch_id]["memory"]
        assert mem["params"] == mem["model"]["params"]
        for name, (held, model) in mem["opt"].items():
            assert held == model
        assert mem["opt"][mem["optimizer"]][0] == mem["model"]["opt_state"]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_padded_gather_equals_the_whole_leaf(mesh_name, runs):
    ranks, _, _ = runs
    x = np.arange(35, dtype=np.float32).reshape(5, 7)
    for res in ranks[mesh_name]:
        for k in ("a", "b"):
            np.testing.assert_array_equal(res["padded"][k], x)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_uneven_encoder_sequence_over_a_mesh(mesh_name, runs):
    """whisper's loss and every rank's gradient blocks with a source of
    UNEVEN_FRAMES frames (ceiling blocks of the encoder's residual,
    padded for the gathers and sum-scatters) against no mesh."""
    ranks, _, twins = runs
    t = twins[UNEVEN_TWIN]
    cfg = PC.get_arch(UNEVEN_TWIN).smoke
    assert UNEVEN_FRAMES % _sizes(mesh_name)["model"]
    batch = {"tokens": torch.from_numpy(t["train_tokens"]),
             "cross_src": torch.from_numpy(
                 t["train_cross"][:, :UNEVEN_FRAMES])}
    loss, grads = make_grad_fn(cfg)(interop.params_from(t["params"], "cpu"),
                                    batch)
    want = [g.numpy() for g in tree_leaves(grads)]
    specs = _spec_leaves(PT.param_specs(cfg))
    for res in ranks[mesh_name]:
        got = res["twins"][UNEVEN_TWIN]["uneven"]
        assert abs(got["loss"] - float(loss)) <= LOSS_RTOL * abs(float(loss))
        _held_to(got["grads"], want, specs, res["coords"], mesh_name)


def _counted(mesh_name: str, arch_id: str, kind: str) -> dict:
    """``step_analysis.analyze`` of the step the worker counted, on meta
    tensors of its shapes, through a counting mesh of the same shape: the
    collectives that mesh counted (rank 0's program)."""
    shape, axes = MESHES[mesh_name]
    mesh = PM.Mesh(dict(zip(axes, shape)), virtual=True, counting=True)
    cfg = PC.get_arch(arch_id).smoke
    meta = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    params = PM.shard_tree(PT.param_shapes(cfg), PT.param_specs(cfg), mesh)
    rows = lambda rules, d: PM.shard_tree(d, PM.batch_specs(mesh, rules, d),
                                          mesh)
    cross = lambda b: ({"cross_src": meta((b, cfg.cross_seq, cfg.d_model),
                                          cfg.dtype)}
                       if cfg.cross_seq else {})
    if kind == "train":
        rules = PM.make_rules(mesh, kind="train", global_batch=B, cfg=cfg)
        opt = W.optimizer(arch_id)
        step = make_train_step(cfg, opt, rules=rules, mesh=mesh)
        batch = rows(rules, {"tokens": meta((B, TRAIN_S), torch.int32),
                             **cross(B)})
        args = (params, init_opt_state(cfg, opt, params), batch, 0)
    elif kind == "prefill":
        rules = PM.make_rules(mesh, kind="prefill", global_batch=B, cfg=cfg)
        step = make_prefill_step(cfg, rules=rules, mesh=mesh,
                                 max_seq=S + STEPS)
        data = rows(rules, {"tokens": meta((B, S), torch.int32), **cross(B)})
        args = (params, data["tokens"], data.get("cross_src"))
    else:
        rules = PM.make_rules(mesh, kind="decode", global_batch=B, cfg=cfg)
        step = make_decode_step(cfg, rules=rules, mesh=mesh)
        cache = PM.shard_tree(PT.cache_shapes(cfg, B, S + STEPS, rules),
                              PT.cache_specs(cfg, B, S + STEPS, rules), mesh)
        tokens = rows(rules, {"tokens": meta((B, 1), torch.int32)})["tokens"]
        args = (params, cache, tokens, S)
    res = SA.analyze(step, *args, mesh=mesh)
    assert res["collectives"]["by_part"] == mesh.parts
    return dict(mesh.stats, parts=mesh.parts, kinds=mesh.kinds)


@pytest.mark.parametrize("kind", ("prefill", "decode", "train"))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_counting_mesh_equals_gloo_mesh(case, kind, runs):
    """A prefill, a decode step and a train step counted on meta tensors
    through a counting mesh issue rank 0's collectives on the gloo mesh
    of the same shape, call for call and byte for byte: in all, by part,
    by kind and the backward's apart.  Every rank issues as many calls
    (ceiling blocks may give the others fewer bytes)."""
    mesh_name, arch_id = case
    ranks, _, _ = runs
    got = [r["twins"][arch_id]["counts"][kind] for r in ranks[mesh_name]]
    assert _counted(mesh_name, arch_id, kind) == got[0]
    assert got[0]["calls"] > 0
    assert len({(g["calls"], g["backward_calls"]) for g in got}) == 1


def test_the_rules_flip_sequence_parallel_attention(runs):
    """The twins take both settings of ``seq_parallel_attn`` from the
    rules (so the flipped runs above cover both)."""
    ranks, _, _ = runs
    got = {a: ranks["2x2"][0]["twins"][a]["sp_attn"] for a in TWINS}
    assert any(got.values()) and not all(got.values())


# ---------------------------------------------------------------------------
# a one-rank mesh in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("one_rank_dense") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield PM.make_smoke_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch_id", TWINS)
def test_one_rank_mesh_is_bit_equal_to_no_mesh(arch_id, one_rank):
    """``serve`` (greedy tokens, final logits) and the loss and every
    gradient leaf through a 1 x 1 mesh, bit for bit: each split's group
    has one rank, so the layers run the arithmetic of no mesh (their
    gathers and sums pass through one-rank groups)."""
    cfg = PC.get_arch(arch_id).smoke
    kw = dict(batch=B, prompt_len=S, gen=STEPS, seed=0, device="cpu")
    want = serve(cfg, **kw)
    one_rank.reset_stats()
    got = serve(cfg, mesh=one_rank, **kw)
    assert one_rank.stats["calls"] > 0
    assert torch.equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits"], want["logits"])
    t = _inputs((arch_id,))[arch_id]
    params = interop.params_from(t["params"], "cpu")
    batch = {"tokens": torch.from_numpy(t["train_tokens"])}
    if "train_cross" in t:
        batch["cross_src"] = torch.from_numpy(t["train_cross"])
    loss0, g0 = make_grad_fn(cfg)(params, batch)
    rules = PM.make_rules(one_rank, kind="train", global_batch=B, cfg=cfg)
    loss1, g1 = make_grad_fn(cfg, rules=rules, mesh=one_rank)(
        PM.shard_tree(params, PT.param_specs(cfg), one_rank), batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
