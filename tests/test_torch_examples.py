"""The port's example, ``examples/quickstart_torch.py``, driven on the CPU
at a small corpus: it builds, searches, inserts and finds an inserted
vector; without a card and without ``--device cpu`` it stops."""
import importlib.util
from pathlib import Path

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

_PATH = (Path(__file__).resolve().parents[1] / "examples" /
         "quickstart_torch.py")


@pytest.fixture(scope="module")
def quickstart():
    spec = importlib.util.spec_from_file_location("quickstart_torch", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_cpu(quickstart, capsys):
    recall, nearest, first_new = quickstart.main(["--device", "cpu",
                                                  "--n", "400"])
    out = capsys.readouterr().out
    assert "built 400 vertices on cpu" in out
    assert recall >= 0.9
    assert nearest == first_new


def test_quickstart_torch_needs_a_card_by_default(quickstart):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        quickstart.main([])
