"""Parity of the port's gather probe with the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its docstring
runs them without a TPU; the port's side runs the plain versions, which is
what `gather_rows` takes for CPU tensors. Inputs are made with numpy from
a seed and handed to both.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np

from nmcfluid.wost import pallas_probe as j_pp

from nmcfluid_torch.ops import radial_tables as t_rt
from nmcfluid_torch.wost import pallas_probe as t_pp

N = 2048


@functools.lru_cache(maxsize=None)
def _radial_table():
    return t_rt.pack_quads(t_rt.build_table(2)).reshape(-1, 4).astype(
        np.float32)


def _inputs(kind, n=N, seed=0):
    rng = np.random.default_rng(seed)
    table = _radial_table() if kind == "radial" else \
        rng.standard_normal(t_pp.ONEHOT_TABLE).astype(np.float32)
    idx = rng.integers(0, table.shape[0], n).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("kind", ["random", "radial"])
@pytest.mark.parametrize("variant", t_pp.VARIANTS)
def test_plain_gather_matches_jax(variant, kind):
    """Bit for bit, tolerance 0: a gather moves values unchanged, and the
    one-hot f32 product has one nonzero term in each sum, so neither side
    rounds."""
    table, idx = _inputs(kind)
    want = np.asarray(j_pp.gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                       variant=variant, interpret=True))
    got = t_pp.gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                           variant)
    assert got.shape == (N, 4)
    assert np.array_equal(to_np(got), want)


def test_rows_gather_is_the_radius_draw_quad():
    """At row i0 * 256 + j0 of the flattened quad table (the probe's
    `walk_indices`), `rows` returns the quad that
    ops/radial_tables.py::sample_t_screened_u gathers as table_quads[i0, j0],
    so the draw built on it is the port's, exactly."""
    quads = torch.from_numpy(t_rt.pack_quads(t_rt.build_table(2)).astype(
        np.float32))
    rng = np.random.default_rng(1)
    Z = torch.from_numpy(np.exp(rng.uniform(np.log(1e-4), np.log(1e5), N))
                         .astype(np.float32))
    u = torch.from_numpy(rng.uniform(0.0, 1.0, N).astype(np.float32))
    # the index arithmetic of sample_t_screened_u
    zi = (torch.log(torch.clamp(Z, t_rt._Z_MIN, t_rt._Z_MAX))
          - t_rt._LOG_Z_MIN) / t_rt._DLOG
    i0 = torch.clamp(torch.floor(zi).to(torch.int64), 0, t_rt._N_Z - 2)
    wi = torch.clamp(zi - i0, 0.0, 1.0)
    uj = u * (t_rt._N_U - 1)
    j0 = torch.clamp(torch.floor(uj).to(torch.int64), 0, t_rt._N_U - 2)
    wj = uj - j0
    rows = t_pp.walk_indices(Z, u)
    assert torch.equal(rows.long(), i0 * (t_rt._N_U - 1) + j0)
    q = t_pp.gather_rows(quads.reshape(-1, 4), rows, "rows")
    assert torch.equal(q, quads[i0, j0])
    t = ((1 - wi) * ((1 - wj) * q[:, 0] + wj * q[:, 1])
         + wi * ((1 - wj) * q[:, 2] + wj * q[:, 3]))
    assert torch.equal(t, t_rt.sample_t_screened_u(quads, Z, u))


@pytest.mark.parametrize("case", ["n_not_a_multiple", "onehot_wrong_table",
                                  "int64_indices", "float64_table",
                                  "index_out_of_range"])
def test_gather_rejects_what_the_kernel_does_not_take(case):
    """The kernel's contract holds on both devices: ValueError, on the CPU
    too, where the plain version alone could have run."""
    table, idx = (torch.from_numpy(a) for a in _inputs("random"))
    variant = "rows"
    if case == "n_not_a_multiple":
        idx = idx[:1000]
    elif case == "onehot_wrong_table":
        table, idx, variant = table[:1024], idx % 1024, "onehot"
    elif case == "int64_indices":
        idx = idx.long()
    elif case == "index_out_of_range":
        idx[7] = table.shape[0]
    else:
        table = table.double()
    with pytest.raises(ValueError):
        t_pp.gather_rows(table, idx, variant)


_FORMS = ("torch", "torch_rows", "torch_lanes", "torch_onehot",
          "torch_quads") + t_pp.VARIANTS


def _check_cpu_main(res, out):
    lines = out.splitlines()
    assert list(res) == list(_FORMS)
    for name, line in zip(_FORMS, lines):
        assert line.split(":")[0].strip() == name
        assert ": OK" in line and "not timed" in line
        assert res[name] == {"ok": True, "ms": None, "err": 0.0}
    assert set(t_pp.PLAIN.values()) <= set(_FORMS)


def test_probe_main_on_cpu(capsys):
    """`--device cpu` runs every form and every baseline as plain versions,
    checks each against table[idx] and times none."""
    res = t_pp.main(["--device", "cpu", "--n", str(N)])
    _check_cpu_main(res, capsys.readouterr().out)


def test_probe_main_on_cpu_radial_table(capsys):
    """The same on the radial table, with the rows the walk's radius draw
    picks: the rows the probe draws span the table's Z range and past both
    ends, so the first and last Z rows are both hit."""
    res = t_pp.main(["--device", "cpu", "--table", "radial", "--n", str(N)])
    _check_cpu_main(res, capsys.readouterr().out)
    table, idx = t_pp.probe_inputs("radial", N, "cpu")
    assert torch.equal(table, torch.from_numpy(_radial_table()))
    i0 = idx // 256
    assert int(i0.min()) == 0 and int(i0.max()) == t_rt._N_Z - 2


def test_probe_profile_needs_the_card():
    with pytest.raises(SystemExit):
        t_pp.main(["--device", "cpu", "--n", str(N), "--profile"])


def test_probe_main_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_pp.main(["--n", str(N)])
