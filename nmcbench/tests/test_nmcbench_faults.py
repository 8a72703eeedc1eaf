"""The check against a broken timed path: a run of the harness (its look
for a card skipped, on the CPU at a tiny size) with a fault planted in
the program underneath must come out not correct, under the cell's own
limits, where the same run with no fault comes out correct.

The faults a frame can have: a step that returns its state unchanged
(the fit's Adam iterations skipped); half of the batch left out (the
fit's loss taken over half of each batch's points); an answer altered
where it is produced (the divergence grid, the pressure gradient, the
walk's estimates, the head solve's weights). The cells run on one chip,
so no exchange between chips can be left out."""
import pytest

from nmcfluid_torch.sim import fluid as fluid_mod

from .conftest import run_tiny, tiny_cell

def _unchanged(fit):
    def f(params, cfg, pool, n_iters, lr):
        out, loss = fit(params, cfg, pool, n_iters, lr)
        return [(W.clone(), b.clone()) for W, b in params], loss
    return f


def _half_batch(fit):
    def f(params, cfg, pool, n_iters, lr):
        x, A, c, t, w = pool
        w = w.clone()
        w[:, w.shape[1] // 2:] = 0.0
        return fit(params, cfg, (x, A, c, t, w), n_iters, lr)
    return f


def _scaled_output(fn, index, factor):
    def f(*args, **kw):
        out = fn(*args, **kw)
        if index is None:
            return out * factor
        out = list(out)
        out[index] = out[index] * factor
        return tuple(out)
    return f


def _head_altered(head):
    def f(fluid, params, key, batch_fn):
        out = head(fluid, params, key, batch_fn)
        W, b = out[-1]
        return out[:-1] + [(W, b + 1e-2 * b.abs().max().clamp(min=1e-3))]
    return f


FAULTS = {
    "state_unchanged": ("fused_adam_fit", _unchanged),
    "half_batch": ("fused_adam_fit", _half_batch),
    "divergence_altered": ("_divergence_grid",
                           lambda f: _scaled_output(f, None, 0.99)),
    "head_altered": ("_ls_head_solve", _head_altered),
}
SPECTRAL = dict(FAULTS, gradp_altered=(
    "_pressure_solve_spectral", lambda f: _scaled_output(f, 3, 0.9)))
WOST = dict(FAULTS, walk_altered=(
    "estimate_solution_and_gradient", lambda f: _scaled_output(f, 1, 0.9)))
CASES = ([("tg.spectral", k) for k in SPECTRAL]
         + [("smoke.spectral", k) for k in SPECTRAL]
         + [("tg.wost", k) for k in WOST])


@pytest.mark.parametrize("cell", ["tg.spectral", "smoke.spectral",
                                  "tg.wost"])
def test_sound_run_is_correct(cell):
    result, _ = run_tiny(tiny_cell(cell))
    assert result["correct"] is True, result["check"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    name, plant = (SPECTRAL if "spectral" in cell else WOST)[fault]
    monkeypatch.setattr(fluid_mod, name, plant(getattr(fluid_mod, name)))
    result, _ = run_tiny(tiny_cell(cell))
    assert result["correct"] is False, result["check"]
    assert result["failed"] == 1

