"""The port's checkpoint store (``repro_torch.checkpoint``) and training
launcher (``repro_torch.launch.train``) on the CPU.

The store's own behaviour (the reference's ``tests/test_substrate.py``
checkpoint tests on the port: a bf16 round trip, ``_gc`` and ``LATEST``,
a torn commit, a torn ``.tmp`` dir); checkpoints both packages read, leaf for leaf and bit for
bit: the reference's params and optimizer state into the port and the
port's into the reference, for a Mamba twin in bf16 (float32 leaves in a
bf16 model, AdamW in bf16) and for arctic's twin (Adafactor's list
state); the launcher's crash at step 3 and resume, bit-equal to a run
without the crash; a resume with ``--remesh`` bit-equal to one without.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import checkpoint as rckpt
from repro import configs as RC
from repro.models import transformer as RT
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch import checkpoint as pckpt
from repro_torch import interop
from repro_torch.launch import train as launcher
from repro_torch.tree import tree_leaves

_ROOT = Path(__file__).resolve().parents[1]
_ref_init = jax.jit(RT.init_params, static_argnums=0)


def _bits(x) -> np.ndarray:
    """A leaf of either package as raw bytes, with its dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return str(t.dtype).removeprefix("torch."), \
            t.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)
    return str(a.dtype), np.frombuffer(a.tobytes(), np.uint8)


def _assert_same_leaves(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(np.shape(b))
        (da, ba), (db, bb) = _bits(a), _bits(b)
        assert da == db
        np.testing.assert_array_equal(ba, bb)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": [torch.tensor(1.5), torch.tensor(7, dtype=torch.int32)],
            "c": {"d": torch.ones(4, dtype=torch.int8),
                  "e": torch.tensor([True, False])}}
    pckpt.save(tmp_path, 3, tree)
    step, out = pckpt.load_latest(tmp_path, tree, device="cpu")
    assert step == 3
    _assert_same_leaves(tree_leaves(out), tree_leaves(tree))


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        pckpt.save(tmp_path, s, tree, keep=2)
    dirs = sorted(d.name for d in tmp_path.iterdir() if d.is_dir())
    assert dirs == ["step_00000004", "step_00000005"]
    assert pckpt.latest_step(tmp_path) == 5


def test_checkpoint_atomic_torn_commit(tmp_path):
    tree = {"x": torch.zeros(2)}
    pckpt.save(tmp_path, 1, tree)
    # a torn commit: LATEST names a missing dir
    (tmp_path / "LATEST").write_text("step_00000099")
    assert pckpt.latest_step(tmp_path) is None
    assert pckpt.load_latest(tmp_path, tree, device="cpu") == (None, None)


def test_checkpoint_torn_tmp_dir_is_skipped_and_collected(tmp_path):
    """A save cut off before its rename leaves ``step_X.tmp``: resume takes
    the last committed step, and the next save removes the torn dir."""
    tree = {"x": torch.arange(3.0)}
    pckpt.save(tmp_path, 1, tree)
    torn = tmp_path / "step_00000002.tmp"
    torn.mkdir()
    (torn / "shard_00000.npz").write_bytes(b"partial")
    step, out = pckpt.load_latest(tmp_path, tree, device="cpu")
    assert step == 1
    _assert_same_leaves(tree_leaves(out), tree_leaves(tree))
    pckpt.save(tmp_path, 3, tree)
    assert not torn.exists()
    assert pckpt.latest_step(tmp_path) == 3


def test_checkpoint_rejects_another_tree(tmp_path):
    pckpt.save(tmp_path, 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="holds leaves"):
        pckpt.load(tmp_path, 1, {"y": torch.zeros(2)}, device="cpu")


# ---------------------------------------------------------------------------
# checkpoints both packages read
# ---------------------------------------------------------------------------

def _ref_state(arch_id, dtype):
    """The reference's params and the optimizer state one step in (the
    arch's optimizer; AdamW's state in bf16), for its smoke twin in
    ``dtype``."""
    arch = RC.get_arch(arch_id)
    cfg = dataclasses.replace(arch.smoke, param_dtype=dtype)
    opt = RO.make_optimizer(arch.optimizer, lr=1e-3)
    params = _ref_init(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                              cfg.vocab_size, jnp.int32)
    step = jax.jit(RS.make_train_step(cfg, opt))
    params, state, _ = step(params, RS.init_opt_state(cfg, opt, params),
                            {"tokens": toks}, jnp.int32(0))
    return {"params": params, "opt": state}


CASES = [("falcon-mamba-7b", "bfloat16"), ("arctic-480b", "float32")]


@pytest.mark.parametrize("arch_id,dtype", CASES)
def test_reference_checkpoint_loads_into_port(tmp_path, arch_id, dtype):
    ref = _ref_state(arch_id, dtype)
    rckpt.save(tmp_path, 7, ref)
    params = interop.params_from(ref["params"], "cpu")
    like = {"params": params,
            "opt": interop.opt_state_from(ref["opt"], params, "cpu")}
    step, got = pckpt.load_latest(tmp_path, like, device="cpu")
    assert step == 7
    _assert_same_leaves(tree_leaves(got), jax.tree.leaves(ref))
    if dtype == "bfloat16":
        mixer = got["params"]["blocks"][0][0]["mixer"]
        assert mixer["A_log"].dtype == torch.float32
        assert mixer["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch_id,dtype", CASES)
def test_port_checkpoint_loads_into_reference(tmp_path, arch_id, dtype):
    ref = _ref_state(arch_id, dtype)
    params = interop.params_from(ref["params"], "cpu")
    tree = {"params": params,
            "opt": interop.opt_state_from(ref["opt"], params, "cpu")}
    pckpt.save(tmp_path, 4, tree)
    step, got = rckpt.load_latest(tmp_path, ref)
    assert step == 4
    _assert_same_leaves(tree_leaves(tree), jax.tree.leaves(got))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_ARGS = ["--arch", "qwen2-0.5b", "--device", "cpu", "--steps", "6",
         "--batch", "4", "--seq", "32", "--ckpt-every", "2",
         "--log-every", "1"]


def _launch(ckpt, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(_ROOT / "src"),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *_ARGS,
         "--ckpt", str(ckpt), *extra], env=env, cwd=_ROOT,
        capture_output=True, text=True, timeout=300)


def test_launcher_crash_and_resume_bit_equal(tmp_path, capsys):
    """Crash at step 3 (exit 42, ``LATEST`` at step 1), resume (steps 2-5,
    a final commit), against 6 steps without the crash, in this process:
    the final checkpoints are equal bit for bit, and so are the logged
    losses."""
    crashed = _launch(tmp_path / "a", "--crash-at", "3")
    assert crashed.returncode == 42, crashed.stderr
    assert "CRASH injected at step 3" in crashed.stdout
    assert (tmp_path / "a" / "LATEST").read_text() == "step_00000001"
    resumed = _launch(tmp_path / "a")
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 1" in resumed.stdout
    assert launcher.main(_ARGS + ["--ckpt", str(tmp_path / "b")]) == 0
    straight = capsys.readouterr().out
    losses = {}
    for name, out in (("resumed", resumed.stdout), ("straight", straight)):
        beats = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        losses[name] = {hb["step"]: hb["loss"] for hb in beats}
    assert sorted(losses["resumed"]) == [2, 3, 4, 5]
    assert all(losses["resumed"][s] == losses["straight"][s]
               for s in range(2, 6))
    for d in ("a", "b"):
        assert (tmp_path / d / "LATEST").read_text() == "step_00000005"
    manifest = (tmp_path / "a" / "step_00000005" / "MANIFEST.json")
    assert manifest.read_text() == (tmp_path / "b" / "step_00000005" /
                                    "MANIFEST.json").read_text()
    with np.load(tmp_path / "a" / "step_00000005" / "shard_00000.npz") as a, \
            np.load(tmp_path / "b" / "step_00000005" / "shard_00000.npz") \
            as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_launcher_remesh_waits_for_the_mesh(tmp_path, capsys):
    """``--remesh`` is accepted, as the reference's launcher accepts it,
    and read nowhere (the launcher builds no mesh): from copies of one
    checkpoint at step 1, a resume with the flag logs the losses and
    commits the final checkpoint of a resume without it, bit for bit."""
    args = ["--arch", "qwen2-0.5b", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--log-every", "1"]
    assert launcher.main(args + ["--steps", "2", "--ckpt",
                                 str(tmp_path / "base")]) == 0
    outs = {}
    for name, extra in (("plain", []), ("remesh", ["--remesh"])):
        shutil.copytree(tmp_path / "base", tmp_path / name)
        capsys.readouterr()
        assert launcher.main(args + ["--steps", "4", "--ckpt",
                                     str(tmp_path / name)] + extra) == 0
        out = capsys.readouterr().out
        assert "resumed from step 1" in out
        outs[name] = [json.loads(ln) for ln in out.splitlines()
                      if ln.startswith("{")]
    assert [(hb["step"], hb["loss"]) for hb in outs["remesh"]] == \
        [(hb["step"], hb["loss"]) for hb in outs["plain"]]
    assert [hb["step"] for hb in outs["plain"]] == [2, 3]
    final = [tmp_path / n / "step_00000003" for n in ("plain", "remesh")]
    assert (final[0] / "MANIFEST.json").read_text() == \
        (final[1] / "MANIFEST.json").read_text()
    with np.load(final[0] / "shard_00000.npz") as a, \
            np.load(final[1] / "shard_00000.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        launcher.main(["--arch", "qwen2-0.5b", "--steps", "1"])
