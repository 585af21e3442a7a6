"""Where the benchmark refuses to run: without a card, without the
program beside it, and with JAX or the JAX package loaded."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import _navisbench_tiny as tiny

REPO = tiny.REPO


def _run(args, cwd, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=timeout)


def _no_result(proc):
    return not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["navisbench/run.py", "--workload", "deep96.query", "--seed",
                 "1", "--seconds", "1", "--trace", "0"], REPO)
    assert proc.returncode == 3 and _no_result(proc)
    assert "needs 1 CUDA device" in proc.stderr


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, even the CPU route fails and prints nothing."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "navisbench", tmp_path / "navisbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from navisbench import run;"
            "sys.exit(run.main(['--workload', 'deep96.query', '--seed', '1',"
            "'--seconds', '1'], device='cpu'))")
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode != 0 and _no_result(proc)
    assert "repro_torch" in proc.stderr


DRIVE = ("import sys, json; sys.path[:0] = [{src!r}, {repo!r}];{pre}"
         "from navisbench import run, harness;"
         "rc = run.main(['--workload', 'deep96.query', '--seed', '1',"
         "'--seconds', '0.3'], root={root!r}, device='cpu');"
         "print(json.dumps({{'rc': rc, 'loaded': sorted({{n.split('.')[0] "
         "for n in sys.modules}})}}))")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _drive(root, pre=""):
    proc = _run(["-c", DRIVE.format(src=str(REPO / "src"), repo=str(REPO),
                                    pre=pre, root=str(root))], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1], proc.stderr


def test_run_loads_nothing_of_jax(root):
    out, lines, _ = _drive(root)
    assert out["rc"] == 0 and json.loads(lines[-1])["correct"] is True
    from navisbench.harness import FORBIDDEN
    assert not set(out["loaded"]) & set(FORBIDDEN)
    assert "repro_torch" in out["loaded"]


def test_run_refuses_the_jax_package(root):
    out, lines, err = _drive(root, pre="import repro.core;")
    assert out["rc"] == 4 and not lines
    assert "'repro" in err and "jax" in err
