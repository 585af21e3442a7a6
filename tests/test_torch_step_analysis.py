"""The step analysis (``repro_torch.launch.step_analysis``, ``trips``, the
counting mesh) against the reference's ``repro.launch.hlo_analysis``.

- Dot FLOPs of every smoke twin's prefill, decode step and AdamW / Adafactor
  train step at 2 x 64, counted on meta tensors, against
  ``hlo_analysis.analyze`` of the reference's jitted step on one device (in
  a subprocess: its compiles overlap nothing here, and ``XLA_FLAGS`` is
  never set in this process).  Decode is equal on all ten; prefill on the
  eight without a Mamba mixer; the rest differ by closed forms, each a
  product one program runs and the other does not (:func:`_expected`).
- The multiplied count (one iteration of each group of alike layers, scan
  chunks, time steps and optimizer slices, times the group's size) equals
  running every iteration, on every field, with no mesh and through a
  counting 2 x 2 mesh.
- Traffic on a small function with known bytes (views at zero), the
  counting mesh's kinds and shapes, ``trips.each``, ``top_contributors``.

The counting mesh's collectives against gloo meshes of 4 ranks are in
``test_torch_mesh_dense.py`` (its worker spawn runs them).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch import configs as C
from repro_torch import trips
from repro_torch.launch import mesh as M
from repro_torch.launch import step_analysis as SA
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
KINDS = ("prefill", "decode", "train")
CASES = [(a, k) for a in C.ARCH_IDS for k in KINDS]
META = torch.device("meta")
LOSS_CHUNK = 1024        # lm_loss's chunk in both packages
REF_SCAN_CHUNK = 512     # the reference's selective_scan chunk

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    from repro import configs as C
    from repro.launch import hlo_analysis as H
    from repro.models import transformer as T
    from repro.train import optimizer as O
    from repro.train.serve_step import make_decode_step, make_prefill_step
    from repro.train.train_step import make_train_step

    B, S = int(sys.argv[1]), int(sys.argv[2])
    f = jax.ShapeDtypeStruct
    out = {}
    for arch_id in C.ARCH_IDS:
        arch = C.get_arch(arch_id)
        cfg = arch.smoke
        ps = T.param_shapes(cfg)
        tokens = f((B, S), jnp.int32)
        cross = (f((B, cfg.cross_seq, cfg.d_model), cfg.dtype)
                 if cfg.cross_seq else None)
        opt = O.make_optimizer(arch.optimizer,
                               state_dtype=arch.opt_state_dtype)
        batch = {"tokens": tokens}
        if cross is not None:
            batch["cross_src"] = cross
        steps = {
            "prefill": (make_prefill_step(cfg), (ps, tokens) + (
                (cross,) if cross is not None else ())),
            "decode": (make_decode_step(cfg), (
                ps, T.cache_shapes(cfg, B, S), f((B, 1), jnp.int32),
                f((), jnp.int32))),
            "train": (make_train_step(cfg, opt), (
                ps, jax.eval_shape(opt.init, ps), batch,
                f((), jnp.int32)))}
        for kind, (fn, args) in steps.items():
            hlo = jax.jit(fn).lower(*args).compile().as_text()
            out[f"{arch_id}:{kind}"] = H.analyze(hlo)["dot_flops"]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_flops():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(B), str(S)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _step(arch_id: str, kind: str, mesh=None):
    """``(step, args)`` of a smoke twin's ``kind`` step at B x S on meta
    tensors (through ``mesh``, a counting mesh, with its rules)."""
    arch = C.get_arch(arch_id)
    cfg = arch.smoke
    kw = {}
    if mesh is not None:
        kw = dict(mesh=mesh, rules=M.make_rules(
            mesh, kind=kind, global_batch=B, cfg=cfg))
    params = T.param_shapes(cfg)
    tokens = torch.empty((B, S), dtype=torch.int32, device=META)
    cross = (torch.empty((B, cfg.cross_seq, cfg.d_model), dtype=cfg.dtype,
                         device=META) if cfg.cross_seq else None)
    if kind == "train":
        opt = O.make_optimizer(arch.optimizer,
                               state_dtype=arch.opt_state_dtype)
        batch = {"tokens": tokens}
        if cross is not None:
            batch["cross_src"] = cross
        if mesh is not None:
            params = M.shard_tree(params, T.param_specs(cfg), mesh)
            batch = M.shard_tree(batch, M.batch_specs(mesh, kw["rules"],
                                                      batch), mesh)
        return make_train_step(cfg, opt, **kw), (params, opt.init(params),
                                                 batch, 0)
    if kind == "prefill":
        return make_prefill_step(cfg, **kw), (params, tokens) + (
            (cross,) if cross is not None else ())
    return make_decode_step(cfg, **kw), (
        params, T.cache_shapes(cfg, B, S),
        torch.empty((B, 1), dtype=torch.int32, device=META), S - 1)


def _layers(cfg, *kinds) -> int:
    return sum(p.repeats * st.count for p in cfg.patterns for st in p.stages
               if st.kind in kinds)


def _expected(arch_id: str, kind: str, port: int) -> int:
    """The reference's dot FLOPs from the port's, by closed forms in B, S
    and the twin's widths (each checked against the compiled HLO):

    - Mamba mixers (prefill and train): the reference scans in chunks of
      512 time steps, the sequence padded to a whole chunk, and contracts
      ``C`` as a dot over the padded chunk, 2 B Lc d_inner N a layer
      (``Lc = ceil(S / 512) * 512``), where the port contracts the S real
      steps.  In training the reference runs three such dots a layer (the
      forward's, the recompute's and dC), the port seven over S (the
      forward's, the recompute's and five in its scan's backward: dC, dB,
      dA, d(dt) and d(dt x), which the reference takes elementwise).
    - The loss (train): the reference pads the ``S - 1`` positions to
      whole chunks of 1,024 (``Lp``) and takes the target logit by a
      one-hot contraction, 2 B Lp V; the port slices the last chunk and
      gathers the target.  The reference's logits products run four
      times over Lp rows with a tied embedding, three with an untied head
      (XLA merges the recompute with the forward), the port's four times
      over S - 1 rows (forward, recompute, and both backward products).
    - llama-vision's cross layers (train): the port's recompute projects
      the patches' K and V again, 2 x 2 B Se D (KV hd) a layer, which the
      reference computes once.
    """
    cfg = C.get_arch(arch_id).smoke
    want = port
    n_ssm = _layers(cfg, "mamba", "hybrid")
    per_step = 2 * B * cfg.d_inner * cfg.ssm_state
    Lc = -(-S // REF_SCAN_CHUNK) * REF_SCAN_CHUNK
    if kind == "prefill":
        want += n_ssm * per_step * (Lc - S)
    if kind == "train":
        want += n_ssm * per_step * (3 * Lc - 7 * S)
        L = S - 1
        Lp = -(-L // LOSS_CHUNK) * LOSS_CHUNK
        logits = 2 * B * cfg.d_model * cfg.vocab_size
        want += (4 if cfg.tie_embeddings else 3) * logits * Lp - \
            4 * logits * L + 2 * B * Lp * cfg.vocab_size
        if not cfg.encoder_layers:
            want -= _layers(cfg, "cross") * 2 * 2 * B * cfg.cross_seq * \
                cfg.d_model * cfg.num_kv_heads * cfg.hd
    return want


@pytest.mark.parametrize("arch_id,kind", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_dot_flops_match_reference(arch_id, kind, ref_flops):
    step, args = _step(arch_id, kind)
    port = SA.analyze(step, *args)
    want = ref_flops[f"{arch_id}:{kind}"]
    assert _expected(arch_id, kind, port["dot_flops"]) == want
    exact = kind == "decode" or (kind == "prefill" and not _layers(
        C.get_arch(arch_id).smoke, "mamba", "hybrid"))
    assert (port["dot_flops"] == want) == exact


MULT_CASES = CASES + [(a, "train-2x2") for a in C.ARCH_IDS]


@pytest.mark.parametrize("arch_id,kind", MULT_CASES,
                         ids=[f"{a}-{k}" for a, k in MULT_CASES])
def test_multiplied_count_equals_full_count(arch_id, kind):
    """Every field, the collectives through a counting 2 x 2 mesh too."""
    runs = []
    for collapse in (True, False):
        mesh = None
        if kind.endswith("2x2"):
            mesh = M.Mesh({"data": 2, "model": 2}, virtual=True,
                          counting=True)
        step, args = _step(arch_id, kind.split("-")[0], mesh)
        runs.append(SA.analyze(step, *args, mesh=mesh, collapse=collapse))
    multiplied, full = runs
    assert full["max_trip"] == 1 and multiplied["max_trip"] > 1
    del multiplied["max_trip"], full["max_trip"]
    assert multiplied == full
    assert multiplied["dot_flops"] > 0 and multiplied["n_ops"] > 0
    if kind.endswith("2x2"):
        assert multiplied["collectives"]["by_part"]


def test_traffic_of_a_known_function():
    """Each op reads its tensor operands and writes its results; views,
    reshapes and allocations move nothing and are not ops; an in-place op
    reads and writes its target."""
    x = torch.empty((8, 16), dtype=torch.float32, device=META)
    w = torch.empty((16, 4), dtype=torch.bfloat16, device=META)

    def fn(x, w):
        y = x.to(torch.bfloat16) @ w          # _to_copy, mm
        z = y.t().contiguous().view(-1)       # t (view), clone, view
        u = z + 1                             # add
        u.mul_(2)                             # mul_
        return torch.empty_like(u)            # allocation

    res = SA.analyze(fn, x, w)
    xb, x16, y = 8 * 16 * 4, 8 * 16 * 2, 8 * 4 * 2
    assert res["n_ops"] == 5
    assert res["hbm_traffic_bytes"] == (xb + x16) + (x16 + 16 * 4 * 2 + y) \
        + 2 * y + 2 * y + 2 * y
    assert res["dot_flops"] == 2 * 8 * 16 * 4
    assert res["collectives"]["bytes_by_kind"]["total"] == 0


def test_work_on_host_tensors_is_not_counted():
    res = SA.analyze(lambda: torch.ones(1000) * 2, collapse=False)
    assert res["n_ops"] == 0 and res["hbm_traffic_bytes"] == 0


def test_collapsing_needs_meta_tensors():
    with pytest.raises(ValueError, match="meta"):
        SA.analyze(lambda x: x * 2, torch.ones(3))
    with pytest.raises(ValueError, match="counting"):
        SA.analyze(lambda: None,
                   mesh=M.make_production_mesh(multi_pod=False))


def test_counting_mesh_runs_rank_zero():
    """Every coordinate 0, rank 0's ceiling blocks, results of the real
    collectives' shapes; calls and bytes in ``stats`` / ``parts`` as a
    real mesh counts them (the input's bytes) and by kind (the result's,
    twice for an all-reduce), each times the trip multiplier."""
    mesh = M.Mesh({"pod": 2, "data": 16, "model": 16}, virtual=True,
                  counting=True)
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert mesh.axis_index("model") == 0 and mesh.flat_index(
        ("pod", "data")) == 0
    x = torch.empty((5, 7), device=META)
    held = M.shard_tree({"x": x}, {"x": M.P(("data", "model"), None)}, mesh)
    assert held["x"].shape == (1, 7)
    g = mesh.all_gather(torch.empty((3, 4), device=META), ("pod", "data"),
                        1, part="fsdp")
    assert g.shape == (3, 128)
    s = mesh.sum_scatter(torch.empty((2, 32, 4), device=META), "model", 1,
                         part="sp")
    assert s.shape == (2, 2, 4)
    with trips.collapsing():
        for _, n in trips.each(range(3)):
            r = mesh.all_reduce(torch.empty((6,), device=META), "model",
                                part="grad")
    assert r.shape == (6,)
    assert mesh.stats == {"calls": 5, "bytes": 48 + 1024 + 3 * 24,
                          "backward_calls": 0, "backward_bytes": 0}
    assert mesh.parts == {"fsdp": {"calls": 1, "bytes": 48},
                          "sp": {"calls": 1, "bytes": 1024},
                          "grad": {"calls": 3, "bytes": 72}}
    assert mesh.kinds["all-gather"] == {"calls": 1, "bytes": 48 * 32}
    assert mesh.kinds["reduce-scatter"] == {"calls": 1, "bytes": 64}
    assert mesh.kinds["all-reduce"] == {"calls": 3, "bytes": 3 * 2 * 24}


def test_each_yields_one_item_a_group_while_collapsing():
    items = [("a", 1), ("a", 2), ("b", 1), ("a", 3)]
    assert list(trips.each(items, lambda t: t[0])) == [(i, 1) for i in items]
    seen = []
    with trips.collapsing():
        for item, n in trips.each(items, lambda t: t[0]):
            seen.append((item, n, trips.multiplier()))
        assert trips.max_trip() == 3 and trips.multiplier() == 1
    assert seen == [(("a", 1), 3, 3), (("b", 1), 1, 1)]
    assert not trips.is_collapsing()


def test_top_contributors_name_their_sites():
    mesh = M.Mesh({"data": 2, "model": 2}, virtual=True, counting=True)
    step, args = _step("moonshot-v1-16b-a3b", "train", mesh)
    traffic = SA.top_contributors(step, *args, mesh=mesh, n=5)
    coll = SA.top_contributors(step, *args, mesh=mesh, kind="collective",
                               n=5)
    for rows in (traffic, coll):
        assert len(rows) == 5
        assert [b for b, _ in rows] == sorted((b for b, _ in rows),
                                              reverse=True)
    assert all(".py:" in label or "backward" in label
               for _, label in traffic + coll)
    assert any(label.startswith(("all-gather", "reduce-scatter",
                                 "all-reduce")) for _, label in coll)
