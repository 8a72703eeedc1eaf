"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or nmcfluid (compared whole: nmcfluid_torch is the program), and the
reference loads nothing of the program either. A run without a card, or
without the program beside the benchmark, exits nonzero and prints no
result."""
import os
import shutil
import subprocess
import sys
import textwrap

from nmcbench import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "nmcfluid"}


def _tops(code, cwd=R.ROOT):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_harness_run_loads_no_jax_package():
    tops = _tops("""
        import sys, torch
        torch.set_num_threads(1)
        from nmcbench.tests.conftest import tiny_cell, run_tiny
        run_tiny(tiny_cell("tg.wost"), trace=1)
        print(*{m.split(".")[0] for m in sys.modules})
        """)
    assert "nmcfluid_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops("""
        import sys, glob, os
        import nmcbench.reference.check, nmcbench.reference.control
        from nmcbench.run import load_module
        for p in glob.glob("nmcbench/configs/*.py"):
            load_module(p, "ref_" + os.path.basename(p)[:-3])
        print(*{m.split(".")[0] for m in sys.modules})
        """)
    assert not tops & (FORBIDDEN | {"nmcfluid_torch"})


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "nmcbench", "--workload", "tg.spectral",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=R.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(R.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(R.HERE, tmp_path / "nmcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "nmcbench", "--workload", "tg.spectral",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
