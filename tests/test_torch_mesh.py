"""The port's mesh (``repro_torch.launch.mesh``, the expert-parallel
``moe_block``, sharded prefill and decode, ``launch.dryrun``) against the
reference on the CPU.

- Rules and specs: ``make_rules``, ``param_specs``, ``cache_shapes`` /
  ``cache_specs``, ``input_specs`` and the optimizers' ``init_specs``
  equal the reference's exactly (the reference reads only
  ``mesh.shape``, so a namespace stands in for its meshes here).
- The dry-run's memory model equals the reference's in integers on the 33
  cells x 2 production meshes, but for one reference fault (below).  The
  reference runs in one subprocess, since importing ``repro.launch.dryrun``
  sets ``XLA_FLAGS``; never set it in this process.
- Over gloo meshes of 4 ranks (data 2 x model 2, and pod 2 x data 1 x
  model 2; one spawn per mesh shape runs every case): ``moe_block`` in both
  regimes, at capacity factors 0.5 (shards drop) and 8.0 (none do), GLU
  and not, with the batch sharded and not, within rtol = atol = 1e-4 of
  the reference's on a JAX mesh of the same shape (4 fake devices, in a
  subprocess); the moonshot and arctic smoke twins' prefill and 4 decode
  steps over the 2 x 2 mesh against the reference's steps jitted with the
  dry-run's in_shardings, logits and caches within 1e-4.
- A 1 x 1 mesh (gloo, one rank, in this process) equals ``mesh=None`` bit
  for bit; a virtual mesh's collective raises; ``moe_block``'s 2-D
  (decode) regime under autograd raises.
"""
import dataclasses
import json
import multiprocessing as mp
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import _torch_mesh_worker
from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as RC
from repro.launch import mesh as RM
from repro.models import transformer as RT
from repro.train import optimizer as RO
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.launch import dryrun as PD
from repro_torch.launch import mesh as PM
from repro_torch.launch.serve import serve
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.layers import is_spec
from repro_torch.train import optimizer as PO
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
RULE_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16},
               "2x2": {"data": 2, "model": 2}, "1x1": {"data": 1, "model": 1}}
TWINS = ("moonshot-v1-16b-a3b", "arctic-480b")
MOE = dict(B=8, S=4, D=16, E=8, F=24, K=2)
TWIN_B, TWIN_S, TWIN_STEPS = 4, 8, 4
CASES = [dict(name=f"{regime}-cf{cf}-{'glu' if glu else 'plain'}-"
              f"{'batch' if batch else 'nobatch'}",
              regime=regime, cf=cf, glu=glu, batch=batch, whole=False)
         for regime in ("gather", "2d") for cf in (0.5, 8.0)
         for glu in (True, False) for batch in (True, False)]
# the expert leaves arriving whole (as param_specs leaves an axis it drops)
WHOLE = [dict(c, name=c["name"] + "-whole", whole=True) for c in CASES
         if c["cf"] == 0.5 and c["glu"] and c["batch"]]
ALL_CASES = CASES + WHOLE


def _isj(x):
    return isinstance(x, JP) or x is None


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=_isj)]


def _port_specs(tree):
    return [tuple(s) for s in tree_leaves(tree, is_leaf=is_spec)]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shapes(tree, port: bool):
    leaves = tree_leaves(tree) if port else jax.tree.leaves(tree)
    return [(tuple(t.shape), _dtype_name(t.dtype)) for t in leaves]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", RULE_MESHES)
@pytest.mark.parametrize("batch", (256, 128, 32, 1))
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_make_rules_matches_reference(kind, batch, mesh_name):
    shape = RULE_MESHES[mesh_name]
    want = RM.make_rules(types.SimpleNamespace(shape=shape), kind=kind,
                         global_batch=batch)
    got = PM.make_rules(PM.Mesh(shape, virtual=True), kind=kind,
                        global_batch=batch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("sp_env", ("", "1"))
@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
def test_make_rules_sequence_parallel_attention(arch_id, sp_env,
                                                monkeypatch):
    """The GQA rule (KV heads gathered when they cost at most half the
    residual) and ``REPRO_SP_ATTN``, with each architecture's config."""
    monkeypatch.setenv("REPRO_SP_ATTN", sp_env)
    shape = RULE_MESHES["16x16"]
    want = RM.make_rules(types.SimpleNamespace(shape=shape), kind="prefill",
                         global_batch=32, cfg=RC.get_arch(arch_id).model)
    got = PM.make_rules(PM.Mesh(shape, virtual=True), kind="prefill",
                        global_batch=32, cfg=PC.get_arch(arch_id).model)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
def test_param_specs_match_reference(arch_id):
    """Leaf for leaf, full width and smoke twin (whose smaller dims drop
    axes by the production sizes, as the reference's do)."""
    for part in ("model", "smoke"):
        want = _ref_specs(RT.param_specs(getattr(RC.get_arch(arch_id),
                                                 part)))
        got = _port_specs(PT.param_specs(getattr(PC.get_arch(arch_id),
                                                 part)))
        assert len(got) > 5 and got == want


@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
def test_cache_shapes_and_specs_match_reference(arch_id):
    """Under decode rules (batch sharded, and batch 1 with the sequence
    over every axis), on both production meshes."""
    for shape in (RULE_MESHES["16x16"], RULE_MESHES["2x16x16"]):
        for batch in (128, 1):
            rr = RM.make_rules(types.SimpleNamespace(shape=shape),
                               kind="decode", global_batch=batch)
            pr = PM.make_rules(PM.Mesh(shape, virtual=True), kind="decode",
                               global_batch=batch)
            rcfg = RC.get_arch(arch_id).model
            pcfg = PC.get_arch(arch_id).model
            want = _ref_specs(RT.cache_specs(rcfg, batch, 4096, rr))
            assert _port_specs(PT.cache_specs(pcfg, batch, 4096, pr)) == want
            shapes = PT.cache_shapes(pcfg, batch, 4096, pr)
            assert _shapes(shapes, True) == _shapes(
                RT.cache_shapes(rcfg, batch, 4096, rr), False)
            assert all(t.device.type == "meta" for t in tree_leaves(shapes))


@pytest.mark.parametrize("cell", [(a, s) for a, s, _ in RC.cells()],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_match_reference(cell):
    """Every cell's step inputs, full width and smoke twin, on the meta
    device."""
    arch_id, shape_name = cell
    shape = RULE_MESHES["16x16"]
    for smoke in (False, True):
        sh = RC.SHAPES[shape_name]
        rr = RM.make_rules(types.SimpleNamespace(shape=shape), kind=sh.kind,
                           global_batch=sh.global_batch)
        pr = PM.make_rules(PM.Mesh(shape, virtual=True), kind=sh.kind,
                           global_batch=sh.global_batch)
        want = RC.input_specs(RC.get_arch(arch_id), sh, smoke=smoke,
                              rules=rr)
        got = PC.input_specs(PC.get_arch(arch_id), PC.SHAPES[shape_name],
                             smoke=smoke, rules=pr)
        assert sorted(got) == sorted(want)
        assert _shapes(got, True) == _shapes(want, False)
        assert all(t.device.type == "meta" for t in tree_leaves(got))


@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
@pytest.mark.parametrize("opt", ("adamw", "adafactor"))
def test_init_specs_match_reference(opt, arch_id):
    """The optimizer state's specs: AdamW's moments as the parameters',
    Adafactor's factors with the reduced dim dropped."""
    for part in ("model", "smoke"):
        rcfg = getattr(RC.get_arch(arch_id), part)
        pcfg = getattr(PC.get_arch(arch_id), part)
        want = RO.make_optimizer(opt).init_specs(RT.param_specs(rcfg),
                                                 RT.param_shapes(rcfg))
        got = PO.make_optimizer(opt).init_specs(PT.param_specs(pcfg),
                                                PT.param_shapes(pcfg))
        assert _port_specs(got) == _ref_specs(want)


# ---------------------------------------------------------------------------
# the dry-run's memory model
# ---------------------------------------------------------------------------

_DRYRUN_SCRIPT = textwrap.dedent("""
    import json
    import repro.launch.dryrun as D
    from repro import configs as C
    from repro.launch import mesh as M
    out = {}
    for name, multi in (("pod16x16", False), ("pod2x16x16", True)):
        mesh = M.make_production_mesh(multi_pod=multi)
        for a, s, _ in C.cells():
            out[f"{a}__{s}__{name}"] = D.analytical_memory(a, s, mesh)
    print(json.dumps(out))
""")
MEM_CELLS = [(a, s, m) for m in ("pod16x16", "pod2x16x16")
             for a, s, _ in RC.cells()]


def _run(script: str, *args: str, timeout: int = 600) -> str:
    """``script`` in a fresh interpreter (the reference's device count is
    set there, never here)."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script, *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def ref_memory():
    return json.loads(_run(_DRYRUN_SCRIPT).strip().splitlines()[-1])


def _float32_leaf_excess(cfg, mesh) -> int:
    """The bytes by which the reference's ``param_shapes`` understates the
    float32 leaves (``A_log``, ``D``, ``dt_bias``: its shape mode gives
    them the model's dtype, its init float32) on one device."""
    flat = tree_flatten_with_path(PT.param_shapes(cfg))
    specs = tree_leaves(PT.param_specs(cfg), is_leaf=is_spec)
    excess = 0
    for (path, leaf), spec in zip(flat, specs):
        if path[-1] in ("A_log", "D", "dt_bias"):
            f32 = PD._sharded_bytes([leaf], [spec], mesh)
            excess += f32 - f32 // 4 * cfg.dtype.itemsize
    return excess


@pytest.mark.parametrize("cell", MEM_CELLS, ids=lambda c: "__".join(c))
def test_analytical_memory_matches_reference(cell, ref_memory):
    """Integer for integer, but for the float32 SSM leaves: the port's
    ``param_shapes`` carries their real float32 (``init_params``'s),
    where the reference's gives them the model's dtype, so the port's
    parameters (and gradients) exceed the reference's by exactly those
    leaves' extra bytes (falcon-mamba and hymba; none elsewhere)."""
    arch_id, shape_name, mesh_name = cell
    mesh = PM.make_production_mesh(multi_pod=mesh_name == "pod2x16x16")
    got = PD.analytical_memory(arch_id, shape_name, mesh)
    want = dict(ref_memory["__".join(cell)])
    excess = _float32_leaf_excess(PC.get_arch(arch_id).model, mesh)
    assert (excess > 0) == (arch_id in ("falcon-mamba-7b", "hymba-1.5b"))
    fixed = ["params"] + (["grads"] if "grads" in want else [])
    for k in fixed:
        want[k] += excess
    want["total"] += excess * len(fixed)
    assert got == want
    assert all(isinstance(v, int) for v in got.values())


def test_reference_param_shapes_understate_float32_leaves():
    """The reference fault the memory test corrects for:
    ``param_shapes`` gives ``A_log`` the model's bfloat16, ``init_params``
    float32."""
    cfg = RC.get_arch("falcon-mamba-7b").smoke
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    shape = RT.param_shapes(cfg)["blocks"][0][0]["mixer"]["A_log"]
    init = RT.init_params(cfg, jax.random.PRNGKey(0))["blocks"][0][0][
        "mixer"]["A_log"]
    assert str(shape.dtype) == "bfloat16" and str(init.dtype) == "float32"
    pcfg = dataclasses.replace(PC.get_arch("falcon-mamba-7b").smoke,
                               param_dtype="bfloat16")
    assert PT.param_shapes(pcfg)["blocks"][0][0]["mixer"]["A_log"].dtype \
        == torch.float32


def test_dryrun_cli_writes_every_cell(tmp_path):
    """``--all --both-meshes``: one JSON per cell and mesh, its memory
    model the function's; then a single cell, skipped when it exists."""
    assert PD.main(["--all", "--both-meshes", "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(MEM_CELLS) == 66
    rec = json.loads((tmp_path / "moonshot-v1-16b-a3b__decode_32k__"
                      "pod2x16x16.json").read_text())
    assert rec["devices"] == 512 and rec["mesh"] == "pod2x16x16"
    assert rec["memory_model"] == PD.analytical_memory(
        "moonshot-v1-16b-a3b", "decode_32k",
        PM.make_production_mesh(multi_pod=True))
    for f in files:
        rec = json.loads(f.read_text())
        assert 0 < rec["memory_model"]["total"] < 2 ** 63
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["n_ops"] > 0 and rec["max_trip"] >= 1
        coll = rec["collectives"]
        assert coll["bytes_by_kind"]["total"] == sum(
            v for k, v in coll["bytes_by_kind"].items() if k != "total") > 0
        assert sum(coll["op_counts"].values()) == sum(
            v["calls"] for v in coll["by_part"].values()) > 0


def test_dryrun_cli_one_cell_and_skip(tmp_path, capsys):
    args = ["--arch", "arctic-480b", "--shape", "train_4k", "--out",
            str(tmp_path)]
    assert PD.main(args) == 0
    rec = json.loads((tmp_path / "arctic-480b__train_4k__pod16x16.json")
                     .read_text())
    assert set(rec) == {"arch", "shape", "mesh", "devices", "memory_model",
                        "flops", "bytes_accessed", "collectives", "n_ops",
                        "max_trip", "analysis_s"}
    assert set(rec["collectives"]) == {"bytes_by_kind", "op_counts",
                                       "by_part"}
    assert set(rec["memory_model"]) == {"params", "opt_state", "grads",
                                        "residual_stack", "total"}
    assert PD.main(args + ["--skip-existing"]) == 0
    assert "SKIP arctic-480b__train_4k__pod16x16" in capsys.readouterr().out


def test_dryrun_cli_dump_top(tmp_path):
    """``--dump-top``: beside the cell's JSON, its 20 largest contributors
    to the traffic and to the collectives (as many as there are sites),
    largest first, each labelled
    with the op (or kind and part) and the site that issued it."""
    args = ["--arch", "moonshot-v1-16b-a3b", "--shape", "prefill_32k",
            "--multi-pod", "--dump-top", "--out", str(tmp_path)]
    assert PD.main(args) == 0
    tag = "moonshot-v1-16b-a3b__prefill_32k__pod2x16x16"
    top = json.loads((tmp_path / f"{tag}.top.json").read_text())
    assert set(top) == {"traffic", "collective"}
    assert len(top["traffic"]) == 20 and 0 < len(top["collective"]) <= 20
    for rows in top.values():
        sizes = [b for b, _ in rows]
        assert sizes == sorted(sizes, reverse=True) and sizes[-1] > 0
        assert all(".py:" in label for _, label in rows)
    assert top["collective"][0][1].split()[0] in PM.KINDS


# ---------------------------------------------------------------------------
# gloo meshes of 4 ranks against the reference on 4 fake devices
# ---------------------------------------------------------------------------

_REF_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs as C
    from repro.launch import mesh as M
    from repro.models import layers as L
    from repro.models import transformer as T
    from repro.train.serve_step import make_decode_step, make_prefill_step

    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    out = {}

    def moe_cases(mesh, w):
        res = {}
        baxes = M.batch_axes(mesh)
        for c in job["cases"]:
            b = (baxes if len(baxes) > 1 else baxes[0]) if c["batch"] \\
                else None
            rules = L.ShardingRules(batch=b, tensor="model", fsdp="data",
                                    moe_gather_weights=c["regime"] ==
                                    "gather")
            names = ("router", "up", "down") + (("gate",) if c["glu"]
                                                else ())
            ps = {k: jax.device_put(jnp.asarray(w[k]), NamedSharding(
                mesh, P("model", "data", None) if k != "router" else P()))
                for k in names}
            xs = jax.device_put(jnp.asarray(w["x"]),
                                NamedSharding(mesh, P(b, None, None)))
            fn = jax.jit(lambda p, x, r=rules, c=c: L.moe_block(
                p, x, n_experts=w["E"], top_k=w["K"],
                capacity_factor=c["cf"], activation="silu", glu=c["glu"],
                mesh=mesh, rules=r))
            res[c["name"]] = np.asarray(fn(ps, xs))
        return res

    def twin(mesh, arch_id, t):
        cfg = C.get_arch(arch_id).smoke
        B, S = t["tokens"].shape
        steps = t["next"].shape[1]
        rp = M.make_rules(mesh, kind="prefill", global_batch=B, cfg=cfg)
        rd = M.make_rules(mesh, kind="decode", global_batch=B, cfg=cfg)
        psh = M.named(mesh, T.param_specs(cfg))
        params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                              t["params"], psh)
        tsh = M.named(mesh, M.batch_specs(mesh, rp,
                                          {"tokens": t["tokens"]}))["tokens"]
        prefill = make_prefill_step(cfg, rules=rp, mesh=mesh,
                                    max_seq=S + steps)
        fn = jax.jit(lambda p, tok: prefill(p, tok),
                     in_shardings=(psh, tsh))
        logits, cache = fn(params, jnp.asarray(t["tokens"]))
        res = {"prefill": np.asarray(logits), "decode": []}
        step = make_decode_step(cfg, rules=rd, mesh=mesh)
        csh = M.named(mesh, T.cache_specs(cfg, B, S + steps, rd))
        dsh = NamedSharding(mesh, P(rd.batch, None))
        dec = jax.jit(lambda p, c, tok, pos: step(p, c, tok, pos),
                      in_shardings=(psh, csh, dsh, None))
        cache = jax.tree.map(jax.device_put, cache, csh)
        for i in range(steps):
            tok = jnp.asarray(t["next"][:, i:i + 1])
            _, logits, cache = dec(params, cache, tok, jnp.int32(S + i))
            res["decode"].append(np.asarray(logits))
        res["cache"] = jax.tree.map(np.asarray, cache)
        return res

    for name, (shape, axes) in job["meshes"].items():
        mesh = M.make_mesh(shape, axes)
        with mesh:
            out[name] = {"moe": moe_cases(mesh, job["moe"])}
            if name == "2x2":
                out[name]["twins"] = {a: twin(mesh, a, t)
                                      for a, t in job["twins"].items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _moe_inputs() -> dict:
    m = MOE
    rng = np.random.default_rng(15)
    return dict(
        E=m["E"], K=m["K"], x=_f32(rng, m["B"], m["S"], m["D"]),
        router=_f32(rng, m["D"], m["E"], scale=0.5),
        up=_f32(rng, m["E"], m["D"], m["F"], scale=m["D"] ** -0.5),
        gate=_f32(rng, m["E"], m["D"], m["F"], scale=m["D"] ** -0.5),
        down=_f32(rng, m["E"], m["F"], m["D"], scale=m["F"] ** -0.5))


def _twin_inputs() -> dict:
    twins = {}
    for i, arch_id in enumerate(TWINS):
        cfg = RC.get_arch(arch_id).smoke
        params = RT.init_params(cfg, jax.random.PRNGKey(i))
        rng = np.random.default_rng(40 + i)
        twins[arch_id] = dict(
            params=jax.tree.map(np.asarray, params),
            tokens=rng.integers(0, cfg.vocab_size,
                                (TWIN_B, TWIN_S)).astype(np.int32),
            next=rng.integers(0, cfg.vocab_size,
                              (TWIN_B, TWIN_STEPS)).astype(np.int32))
    return twins


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_job")
    w = dict(meshes=MESHES, cases=ALL_CASES, moe=_moe_inputs(),
             twins=_twin_inputs())
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(w, f)
    return d, w


@pytest.fixture(scope="module")
def ref_mesh(job):
    """The reference on JAX meshes of 4 fake devices (one subprocess)."""
    d, _ = job
    _run(_REF_SCRIPT, str(d / "job.pkl"), str(d / "ref.pkl"), timeout=900)
    with open(d / "ref.pkl", "rb") as f:
        return pickle.load(f)


def _spawn(d: Path, name: str, w: dict) -> list:
    """Four gloo ranks on mesh ``name`` through a ``file://`` store: each
    writes its results; returns them by rank."""
    shape, axes = MESHES[name]
    sub = dict(shape=shape, axes=axes, cases=w["cases"], moe=w["moe"])
    if name == "2x2":
        sub["twins"] = w["twins"]
    job_file, out = d / f"job_{name}.pkl", d / f"out_{name}"
    with open(job_file, "wb") as f:
        pickle.dump(sub, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_mesh_worker.run,
                         args=(r, 4, str(d / f"store_{name}"),
                               str(job_file), str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
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


@pytest.fixture(scope="module")
def ranks(job):
    d, w = job
    return {name: _spawn(d, name, w) for name in MESHES}


def _rows(coords: dict, mesh_name: str, batched: bool, n: int) -> slice:
    """The global rows rank ``coords`` holds of ``n`` batch rows."""
    if not batched:
        return slice(0, n)
    shape, axes = MESHES[mesh_name]
    sizes = dict(zip(axes, shape))
    flat, k = 0, 1
    for a in ("pod", "data"):
        if a in sizes:
            flat = flat * sizes[a] + coords[a]
            k *= sizes[a]
    return slice(flat * n // k, (flat + 1) * n // k)


@pytest.mark.parametrize("case", [c["name"] for c in ALL_CASES])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_moe_block_over_a_mesh_matches_reference(mesh_name, case, ranks,
                                                 ref_mesh):
    """Every rank's rows of the expert-parallel block equal the
    reference's on a JAX mesh of the same shape.  The ``-whole`` cases
    give each rank whole expert leaves (as a ``param_specs`` that dropped
    an axis would): the block slices its own, where JAX's clamped
    ``dynamic_slice`` would repeat one slice on every fsdp rank."""
    c = next(c for c in ALL_CASES if c["name"] == case)
    want = ref_mesh[mesh_name]["moe"][case.removesuffix("-whole")]
    for res in ranks[mesh_name]:
        rows = _rows(res["coords"], mesh_name, c["batch"], MOE["B"])
        _close(res["moe"][case], want[rows])


def test_capacity_is_per_batch_shard_in_the_gather_regime(ref_mesh):
    """At factor 0.5 the gather regime's per-shard capacity drops other
    assignments than the decode regime's global one, so the two differ;
    at 8.0 nothing drops and they agree (so the cases above hold the
    drops, not only the sums)."""
    moe = ref_mesh["2x2"]["moe"]
    assert not np.allclose(moe["gather-cf0.5-glu-batch"],
                           moe["2d-cf0.5-glu-batch"], **TOL)
    _close(moe["gather-cf8.0-glu-batch"], moe["2d-cf8.0-glu-batch"])


@pytest.mark.parametrize("what", ("prefill", "decode", "cache"))
@pytest.mark.parametrize("arch_id", TWINS)
def test_smoke_twin_over_a_mesh_matches_reference(arch_id, what, ranks,
                                                  ref_mesh):
    """Prefill then 4 teacher-forced decode steps over the 2 x 2 mesh,
    every leaf placed by ``param_specs``: each rank's rows of the logits
    at every step and of the final caches (its block of the positions
    over the decode rules' ``seq``) against the reference's steps jitted
    with the dry-run's in_shardings."""
    want = ref_mesh["2x2"]["twins"][arch_id]
    for res in ranks["2x2"]:
        got = res["twins"][arch_id]
        rows = _rows(res["coords"], "2x2", True, TWIN_B)
        if what == "prefill":
            _close(got["prefill"], want["prefill"][rows])
        elif what == "decode":
            assert len(got["decode"]) == TWIN_STEPS
            for g, w in zip(got["decode"], want["decode"]):
                _close(g, w[rows])
        else:
            g_leaves = jax.tree.leaves(got["cache"])
            w_leaves = jax.tree.leaves(want["cache"])
            assert len(g_leaves) == len(w_leaves) > 0
            n = TWIN_S + TWIN_STEPS
            m = res["coords"]["model"]
            for g, w in zip(g_leaves, w_leaves):
                _close(g, w[:, :, rows, m * n // 2:(m + 1) * n // 2])


@pytest.mark.parametrize("mesh_name", MESHES)
def test_ranks_sit_row_major_and_shard_tree_cuts_ceiling_blocks(
        mesh_name, ranks):
    """Rank r sits at the row-major coordinates of r; ``shard_tree``
    gives rank blocks of ``ceil(dim / n)`` (the last shorter), by the
    flattened index over a tuple of axes, the first major."""
    shape, axes = MESHES[mesh_name]
    x = np.arange(35, dtype=np.float32).reshape(5, 7)
    for r, res in enumerate(ranks[mesh_name]):
        coords = dict(zip(axes, np.unravel_index(r, shape)))
        assert res["coords"] == coords
        split = [a for a in axes if dict(zip(axes, shape))[a] > 1]
        flat = int(np.ravel_multi_index([coords[a] for a in split],
                                        [dict(zip(axes, shape))[a]
                                         for a in split]))
        np.testing.assert_array_equal(res["blocks"]["a"],
                                      x[2 * flat:2 * flat + 2])
        d, m = coords["data"], coords["model"]
        nd, nm = dict(zip(axes, shape))["data"], 2
        rd, rm = -(-5 // nd), -(-7 // nm)
        np.testing.assert_array_equal(
            res["blocks"]["b"], x[d * rd:(d + 1) * rd, m * rm:(m + 1) * rm])
        np.testing.assert_array_equal(res["blocks"]["c"], x)
        assert res["stats"]["calls"] > 0 and res["stats"]["bytes"] > 0


# ---------------------------------------------------------------------------
# a 1 x 1 mesh in this process; virtual meshes; autograd
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo world of one rank in this process, torn down after."""
    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield PM.make_smoke_mesh()
    finally:
        dist.destroy_process_group()


def _moe_torch(glu=True):
    w = _moe_inputs()
    names = ("router", "up", "down") + (("gate",) if glu else ())
    return ({k: torch.from_numpy(w[k]) for k in names},
            torch.from_numpy(w["x"]))


@pytest.mark.parametrize("glu", (True, False))
@pytest.mark.parametrize("regime", ("gather", "decode"))
def test_one_by_one_mesh_equals_no_mesh_bit_for_bit(regime, glu, one_rank):
    """A 1 x 1 mesh changes no arithmetic, in either regime (its
    collectives go through one-rank gloo groups)."""
    w, x = _moe_torch(glu)
    rules = PM.make_rules(one_rank, kind="prefill" if regime == "gather"
                          else "decode", global_batch=MOE["B"])
    kw = dict(n_experts=MOE["E"], top_k=MOE["K"], capacity_factor=0.5,
              activation="silu", glu=glu)
    before = one_rank.stats["calls"]
    got = PL.moe_block(w, x, mesh=one_rank, rules=rules, **kw)
    assert one_rank.stats["calls"] > before
    assert torch.equal(got, PL.moe_block(w, x, **kw))


@pytest.mark.parametrize("arch_id", TWINS)
def test_serve_through_one_by_one_mesh_equals_no_mesh(arch_id, one_rank):
    """``launch.serve.serve`` with ``mesh``: greedy tokens and final logits
    equal to the ``mesh=None`` serve, bit for bit."""
    cfg = PC.get_arch(arch_id).smoke
    kw = dict(batch=4, prompt_len=8, gen=4, seed=0, device="cpu")
    want = serve(cfg, **kw)
    got = serve(cfg, mesh=one_rank, **kw)
    assert torch.equal(got["tokens"], want["tokens"])
    assert torch.equal(got["logits"], want["logits"])


def test_virtual_mesh_runs_no_collective():
    mesh = PM.make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.coords is None
    x = torch.zeros(4)
    for call in (lambda: mesh.all_reduce(x, "model", part="tp"),
                 lambda: mesh.all_gather(x, ("pod", "data"), part="fsdp"),
                 lambda: mesh.axis_index("data"),
                 lambda: PM.shard_tree({"x": x}, {"x": PL.P("data")},
                                       mesh)):
        with pytest.raises(RuntimeError, match="virtual"):
            call()


def test_moe_over_a_mesh_under_autograd_raises(one_rank):
    """The 2-D (decode) regime runs forward only, as the reference's train
    rules never take it; the gather regime trains
    (``test_torch_mesh_train.py``)."""
    w, x = _moe_torch()
    x.requires_grad_(True)
    kw = dict(n_experts=MOE["E"], top_k=MOE["K"], capacity_factor=1.25,
              activation="silu", glu=True, mesh=one_rank)
    rules = PM.make_rules(one_rank, kind="decode", global_batch=MOE["B"])
    with pytest.raises(NotImplementedError, match="forward only"):
        PL.moe_block(w, x, rules=rules, **kw)
    train = PM.make_rules(one_rank, kind="train", global_batch=MOE["B"])
    assert PL.moe_block(w, x, rules=train, **kw).requires_grad


def test_mesh_axes_out_of_order_raise(one_rank):
    with pytest.raises(ValueError, match="order"):
        one_rank.all_gather(torch.zeros(2), ("model", "data"), part="tp")
    with pytest.raises(ValueError, match="not all in the mesh"):
        one_rank.all_reduce(torch.zeros(2), "pod", part="tp")
