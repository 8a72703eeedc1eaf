"""Helpers of the benchmark's CPU tests: a cell at a tiny size, run
through the harness on the CPU (the program's plain twins), with one
torch thread. The cells are BENCHMARK.json's and the walk cell that
waits for a bound (walk_cell.json: its workload and metrics), so that
the harness's walk path stays tested."""
import json
import os

import pytest
import torch

from nmcbench import run as R

TINY = dict(max_n_iters=200, sample_resolution=32, wost_resolution=16,
            div_resolution=16, fit_pool=4, n_walks=64)
# the walk's numbers read a noisy estimate against a grid solve: under the
# walk a tiny cell keeps 500 walks at 16,384 points and the
# configuration's own divergence grid, so that a sound run keeps within
# the cell's limits
WALK = dict(wost_resolution=128, n_walks=500)


def bench():
    """BENCHMARK.json with the walk cell's entries added."""
    out = R.load_json(R.ROOT, "BENCHMARK.json")
    with open(os.path.join(os.path.dirname(__file__), "walk_cell.json")) as f:
        for key, entries in json.load(f).items():
            out[key] = out[key] + entries
    return out


def set_size(cfg, key, value):
    """Set a size where the configuration file keeps it: the fluid's own
    settings, else the scene's."""
    (cfg["fluid"] if key in cfg["fluid"] else cfg["scene_fields"])[key] = \
        value


def tiny_cell(name, bench_=None, here=R.HERE, **over):
    """The cell `name` at TINY's sizes (WALK's under the walk), then
    `over`; its check drawn among the window's first two frames."""
    cell = R.Cell(name, bench=bench_ or bench(), here=here)
    sizes = dict(TINY)
    if cell.traffic["projection"] == "wost":
        sizes.update(WALK, div_resolution=cell.cfg["fluid"]["div_resolution"])
    sizes.update(over)
    for key, value in sizes.items():
        set_size(cell.cfg, key, value)
    cell.limits["check_frames"] = 2
    return cell


def run_tiny(cell, seed=12345678901, seconds=0.3, trace=0, keep=None):
    import time
    return R.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                      keep=keep)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
