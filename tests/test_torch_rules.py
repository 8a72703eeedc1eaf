"""The port's two standing rules, checked on the source and on the CPU.

1. The port stands alone: no module of nmcfluid_torch/ and not
   chip_smoke.py imports JAX or the JAX package (only the parity tests
   import both); its command-line entry points (run.py, replay.py) load
   neither.
2. Its entry points run on the card unless the caller asks for the CPU:
   without a card, the default raises instead of falling back.

And the port's CLI takes the JAX CLI's flags, dests and defaults, plus
--device.
"""
import argparse
import ast
import pathlib
import subprocess
import sys

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


def test_cli_entry_points_load_no_jax():
    """Importing and parsing with run.py and replay.py loads no module of
    JAX or of the JAX package (a fresh interpreter: this one has both)."""
    code = ("import sys\n"
            "import nmcfluid_torch.run as r, nmcfluid_torch.replay as p\n"
            "r.build_parser().parse_args(['taylorgreen'])\n"
            "p.build_parser().parse_args(['smoke', 'energy', '--exp', 'x'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'nmcfluid'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_cli_needs_a_card_unless_asked_for_cpu(tmp_path):
    """Without a card run.py and replay.py raise before writing anything;
    with --device cpu they build their fluid on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nmcfluid_torch import replay, run
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run.main(["taylorgreen", "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        replay.main(["taylorgreen", "energy", "--exp", str(tmp_path)])
    args = run.parse_args(["karman", "--device", "cpu"])
    assert run.make_fluid(args).device == torch.device("cpu")


def _flags(parser):
    """{option strings: (dest, default, choices, type, nargs, const)} of a
    parser's arguments, the positionals under their dest."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(a.option_strings) or (a.dest,)
        out[key] = (a.dest, a.default, a.choices and sorted(a.choices),
                    a.type, a.nargs, a.const)
    return out


@pytest.mark.parametrize("entry", ["run", "replay"])
def test_cli_parser_is_the_jax_parser_plus_device(entry, monkeypatch):
    """The same flags, dests, defaults and choices as the JAX CLI (scenes
    included: the port names the unported ones and raises for them), plus
    --device."""
    import importlib
    jax_cli = importlib.import_module(f"nmcfluid.{entry}")
    port_cli = importlib.import_module(f"nmcfluid_torch.{entry}")
    if entry == "run":
        jax_parser = jax_cli.build_parser()
    else:
        # the JAX replay builds its parser inside main: catch it there
        seen = []

        def grab(self, *a, **kw):
            seen.append(self)
            raise SystemExit(0)
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            jax_cli.main([])
        monkeypatch.undo()
        jax_parser, = seen
    got = _flags(port_cli.build_parser())
    dev = got.pop(("--device",))
    assert dev[:2] == ("device", "cuda")
    assert got == _flags(jax_parser)
