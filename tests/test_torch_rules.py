"""The port's two standing rules, checked on the source and on the CPU.

1. The port stands alone: no module of nmcfluid_torch/ and not
   chip_smoke.py imports JAX or the JAX package (only the parity tests
   import both).
2. Its entry points run on the card unless the caller asks for the CPU:
   without a card, the default raises instead of falling back.
"""
import ast
import pathlib

import pytest
import torch

from nmcfluid_torch.scenes import get_scene
from nmcfluid_torch.sim.fluid import NeuralFluid

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "nmcfluid")


def _imports(path):
    """(line, module) of every absolute import in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "nmcfluid_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for line, mod in _imports(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_neural_fluid_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("taylorgreen", "karman", "smoke"):
        scene = get_scene(name)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            NeuralFluid(scene)
        assert NeuralFluid(scene, device="cpu").device == torch.device("cpu")
