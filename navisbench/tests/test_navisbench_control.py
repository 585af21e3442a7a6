"""The control (``navisbench/control.py``): the reference in TF32 in the
program's place comes out not correct, and the program correct, on a
cell cut to a test's size.  TF32 exists only on a CUDA device, so on a
machine without one this skips; on the card it runs where the program's
kernels do."""
import pytest
import torch

import _navisbench_tiny as tiny


@pytest.mark.parametrize("cell", ["deep96.query"])
def test_control_is_not_correct(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control computes in TF32")
    from navisbench import control
    root = tiny.make_root(tmp_path)
    for seed in (1, 2, 3):
        r = control.readings(root, cell, seed, 2.0)
        assert r["program"]["correct"] is True
        assert r["control"]["correct"] is False
