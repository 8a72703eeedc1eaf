"""The control on the card: the reference put in the program's place in
TF32 (reference/control.py), at a recorded frame's questions, must come
out not correct under the cell's limits, where the program's own frame
comes out correct. Cut in iterations, pool and clouds to a size a test
run holds; `python3 -m nmcbench.readings` reads it at the cells' own
size."""
import time

import pytest
import torch

from nmcbench import run as R
from nmcbench.reference.check import check_frame, judge
from nmcbench.reference.control import control_record
from nmcbench.reference.frame import Scene

from .conftest import tiny_cell

SIZE = dict(max_n_iters=1000, sample_resolution=32, fit_pool=64,
            wost_resolution=128, n_walks=500, div_resolution=1000)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tg.spectral", "smoke.spectral",
                                  "tg.wost"])
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need a CUDA device")
    c = tiny_cell(cell, **dict(SIZE, div_resolution=80 if "smoke" in cell
                               else 1000))
    keep = {}
    res, _ = R.run_cell(c, 2000000000 + len(cell), 1e-3, 0, "cuda",
                        time.perf_counter(), keep=keep, check_frames=1)
    assert res["correct"] is True, res["check"]
    scene = Scene(c.cfg, c.scene_ref)
    numbers, _ = check_frame(scene, control_record(scene, keep["record"],
                                                   "tf32"))
    ok, table = judge(numbers, c.limits["numbers"])
    assert ok is False, table
