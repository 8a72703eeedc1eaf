"""The comparison that decides `correct`: one frame that the program
produced in the window, held against the reference.

A frame's record (`Record`) holds what the timed frame took in and gave
out: the velocity it started from, and for each phase fit the start
weights, the pool of minibatches it fitted (its points, and the A, c,
target and w the program derived at them), the weights after the Adam
iterations, the head solve's batches and the weights it returned; the
divergence grid; the pressure cloud with its `valid` flags, p and grad
p. The points are
random questions the program drew; every answer at them is worked out
again here, in float64 unless said otherwise:

  pool       the pools' A (worst entry; A is dimensionless), c and
             targets (worst entry over the largest target), and every
             loss weight w (in the fluid or not, as the configuration's
             fluid_mask says; infinite where one differs); the
             projection targets use the program's grad p,
             judged by the pressure numbers; points whose boundary value
             the program draws at random are skipped and counted
  adv_fit,   the Adam iterations, run again in float32 (TF32 off) from
  prj_fit    the same start on the program's pool (which `pool` has
             held against the reference's): RMS of the velocity gap over
             the pool's first batches, over the targets' RMS
  adv_head,  the head solve from the program's Adam weights on the same
  prj_head   batches: RMS velocity gap over the targets' RMS (infinite
             where a batch's w is not the reference's)
  div        the divergence grid of the advected velocity (the advection
             fit's result): RMS gap over the reference's RMS
  p, gradp   (spectral) the pressure and its gradient at the cloud: RMS
             gap over the reference's RMS (infinite, as the walk's, where
             a cloud point's `valid` is not the reference's)
  walk_bias, (wost) the walk's gradient estimates against the
  walk_noise deterministic solve of the same problem: |regression slope
             - 1|, and the RMS gap over the reference's RMS
"""
import math

import torch

from . import frame as F

FIT_SAMPLE_BATCHES = 8      # pool batches the fits' velocity gap is read on
POOL_BLOCK = 8              # pool batches recomputed at a time


class Record:
    """What one timed frame took in and gave out (see the module
    docstring); `phases` maps "adv" and "prj" to dicts with params0,
    pool (x, A, c, target, w), n_iters, lr, adam, head [(x, target, w)],
    out, and for "prj" prev (the velocity the projection started from)."""

    def __init__(self):
        self.prev = self.eps = self.t = self.projection = None
        self.div = self.pts = self.valid = self.p = self.grad_p = None
        self.phases = {"adv": {}, "prj": {}}


def _rms(a):
    return float(torch.sqrt(torch.mean(a.double() ** 2))) if a.numel() \
        else 0.0


def _velocity(params, x, A, c):
    raw = F.siren.forward(params, x)
    return torch.einsum("...de,...e->...d", A, raw) + c


def _pool_targets(scene, phase, rec, prec):
    """The reference's (A, c, target, drawn) of every pool batch of
    `phase` ("adv" or "prj"), the projection's matched to the cloud;
    yields per block of batches with the program's pool beside it."""
    ph = rec.phases[phase]
    x = ph["pool"][0]
    K = x.shape[0]
    for s in F.blocks(K, POOL_BLOCK):
        xs = x[s]
        if phase == "adv":
            A, c, tgt, drawn = F.advect_pool(scene, rec.prev, xs, rec.eps,
                                             rec.t, prec)
            found = torch.ones(xs.shape[:-1], dtype=torch.bool,
                               device=xs.device)
        else:
            idx, found = F.cloud_index(rec.pts, xs)
            A, c, tgt, drawn = F.project_pool(
                scene, ph["prev"], xs, rec.grad_p[idx], rec.eps, rec.t, prec)
        yield s, A, c, tgt, drawn, found


def _weights(scene, x, w0):
    """The reference's loss weights at x (1 in the fluid, 0 outside it;
    the program's where float32 may decide otherwise), and how many of
    the program's w0 differ from them."""
    inside, band = scene.fluid_mask(x.double())
    w1 = torch.where(band, w0, inside.to(w0.dtype))
    return w1, int((w0 != w1).sum())


def cloud_valid(scene, rec):
    """The reference's own `valid` at the pressure cloud, and how many of
    the program's recorded flags differ from it."""
    w, bad = _weights(scene, rec.pts, rec.valid.float())
    return w > 0.5, bad


def rebuild_pool(scene, phase, rec, prec, stats=None):
    """The pool the reference fits: its own A, c, target and w at the
    program's points (the program's values at drawn points), float32.
    With `stats` (a dict), the worst gaps to the program's pool go there."""
    x, A0, c0, t0, w0 = rec.phases[phase]["pool"]
    A1, c1, t1, w1 = (torch.empty_like(a) for a in (A0, c0, t0, w0))
    worst_a, worst, scale, n_drawn, missing, w_bad = 0.0, 0.0, 0.0, 0, 0, 0
    for s, A, c, tgt, drawn, found in _pool_targets(scene, phase, rec, prec):
        w1[s], bad = _weights(scene, x[s], w0[s])
        w_bad += bad
        keep = ~drawn
        dA = (A - A0[s].to(A.dtype)).abs().amax(dim=(-1, -2))
        dc = (c - c0[s].to(c.dtype)).abs().amax(dim=-1)
        dt_ = (tgt - t0[s].to(tgt.dtype)).abs().amax(dim=-1)
        worst_a = max(worst_a, float(torch.where(keep, dA, 0.0).max()))
        worst = max(worst, float(torch.where(keep, torch.maximum(dc, dt_),
                                             0.0).max()))
        scale = max(scale, float(torch.where(keep[..., None], tgt.abs(),
                                             0.0).max()))
        n_drawn += int(drawn.sum())
        missing += int((~found).sum())
        A1[s] = torch.where(drawn[..., None, None], A0[s], A.float())
        c1[s] = torch.where(drawn[..., None], c0[s], c.float())
        t1[s] = torch.where(drawn[..., None], t0[s], tgt.float())
    if stats is not None:
        stats[phase] = dict(worst_A=worst_a, worst=worst, scale=scale,
                            drawn=n_drawn, missing=missing, w_mismatch=w_bad)
    return x, A1, c1, t1, w1


def rebuild_head(scene, phase, rec, prec, stats=None):
    """The head solve's batches with the reference's A, c, target and w;
    with `stats` (a dict), the count of the program's w that differ from
    the reference's goes there."""
    out, w_bad = [], 0
    ph = rec.phases[phase]
    for x, tgt0, w in ph["head"]:
        if phase == "adv":
            A, c, tgt, drawn = F.advect_pool(scene, rec.prev, x, rec.eps,
                                             rec.t, prec)
        else:
            idx, found = F.cloud_index(rec.pts, x)
            A, c, tgt, drawn = F.project_pool(
                scene, ph["prev"], x, rec.grad_p[idx], rec.eps, rec.t, prec)
            drawn = drawn | ~found
        tgt = torch.where(drawn[..., None], tgt0.to(tgt.dtype), tgt)
        w, bad = _weights(scene, x, w)
        w_bad += bad
        out.append((x, A, c, tgt, w))
    if stats is not None:
        stats[f"{phase}_head_w_mismatch"] = w_bad
    return out


def fit_gap(prog, ref, pool):
    """RMS velocity gap of two weights over the pool's first batches, over
    the targets' RMS."""
    x, A, c, tgt, _ = (a[:FIT_SAMPLE_BATCHES].double() for a in pool)
    up = _velocity(F.siren.cast(prog, torch.float64), x, A, c)
    ur = _velocity(F.siren.cast(ref, torch.float64), x, A, c)
    return _rms(up - ur) / max(_rms(tgt), 1e-30)


def _head_gap(prog_final, cand, start, losses, batches):
    """The program's returned weights against the reference's choice;
    where the two losses that decide it are within 1e-3 of each other,
    against whichever of the two lies nearer."""
    lc, ls = losses
    choices = [cand if lc <= ls else start]
    if abs(lc - ls) <= 1e-3 * max(abs(ls), 1e-30):
        choices = [cand, start]
    gaps = []
    for ref in choices:
        num, den = 0.0, 0.0
        for x, A, c, tgt, w in batches[:-1]:
            x, A, c, tgt = (a.double() for a in (x, A, c, tgt))
            up = _velocity(F.siren.cast(prog_final, torch.float64),
                           x, A, c)
            ur = _velocity(F.siren.cast(ref, torch.float64), x, A, c)
            num += float(torch.sum((up - ur) ** 2))
            den += float(torch.sum(tgt ** 2))
        gaps.append(math.sqrt(num / max(den, 1e-300)))
    return min(gaps)


def check_phase(scene, phase, rec, notes):
    """adv/prj numbers of one phase: (pool gap, fit gap, head gap)."""
    ph = rec.phases[phase]
    stats = {}
    pool = rebuild_pool(scene, phase, rec, "f64", stats)
    st = stats[phase]
    notes[f"{phase}_pool"] = st
    pool_gap = max(st["worst_A"], st["worst"] / max(st["scale"], 1e-30))
    if st["missing"] or st["w_mismatch"]:
        pool_gap = math.inf
    # the Adam iterations run again on the program's own pool, which the
    # pool number has just held against the reference's
    ref_adam = F.adam_fit(ph["params0"], ph["pool"], ph["n_iters"], ph["lr"],
                          "f32")
    fit_num = fit_gap(ph["adam"], ref_adam, pool)
    del pool
    batches = rebuild_head(scene, phase, rec, "f64", notes)
    cand, start, losses = F.head_solve(ph["adam"], batches, "f64")
    head_gap = _head_gap(ph["out"], cand, start, losses, batches)
    if notes[f"{phase}_head_w_mismatch"]:
        head_gap = math.inf
    notes[f"{phase}_head_losses"] = losses
    return pool_gap, fit_num, head_gap


def check_projection(scene, rec, notes):
    """The divergence grid and the pressure numbers."""
    pts = F.grid_points(scene.box, scene.div_resolution, scene.dim,
                        rec.div.device)
    if tuple(pts.shape[:-1]) != tuple(rec.div.shape):
        # the program's grid is not the method's: no number can hold
        notes["div_shape"] = list(rec.div.shape)
        return {"div": math.inf}
    flat = pts.reshape(-1, scene.dim)
    div_ref, drawn = F.neg_divergence(scene, rec.phases["prj"]["prev"], flat,
                                      rec.eps, rec.t, "f64")
    prog = rec.div.reshape(-1).double()
    keep = ~drawn
    out = {"div": _rms((prog - div_ref)[keep]) / max(_rms(div_ref[keep]),
                                                     1e-30)}
    notes["div_drawn"] = int(drawn.sum())
    div_grid = div_ref.reshape(rec.div.shape)
    valid, notes["valid_mismatch"] = cloud_valid(scene, rec)
    p, g, band = F.pressure(scene, div_grid, rec.pts, valid, "f64")
    keep = ~band
    gp = rec.grad_p.double()[keep]
    gr = g[keep]
    if rec.projection == "spectral":
        out["p"] = _rms((rec.p.double() - p)[keep]) / max(_rms(p[keep]),
                                                          1e-30)
        out["gradp"] = _rms(gp - gr) / max(_rms(gr), 1e-30)
    else:
        d = gp - gr
        slope = float(torch.sum(gp * gr) / torch.clamp(torch.sum(gr * gr),
                                                       min=1e-300))
        out["walk_bias"] = abs(slope - 1.0)
        out["walk_noise"] = _rms(d) / max(_rms(gr), 1e-30)
    if notes["valid_mismatch"]:
        # the program's fluid points are not the reference's
        out.update({k: math.inf for k in out if k != "div"})
    return out


def check_frame(scene, rec):
    """(numbers, notes) of one recorded frame."""
    notes = {}
    out = {}
    a_pool, out["adv_fit"], out["adv_head"] = check_phase(scene, "adv", rec,
                                                          notes)
    out.update(check_projection(scene, rec, notes))
    p_pool, out["prj_fit"], out["prj_head"] = check_phase(scene, "prj", rec,
                                                          notes)
    out["pool"] = max(a_pool, p_pool)
    return out, notes


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}) in the limits' order; a
    number that is not finite fails. A number the cell's limits do not
    name is not compared (its reading stays in the run's notes)."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        table[name] = {"value": v, "limit": limit}
        if not (math.isfinite(v) and v <= limit):
            ok = False
    return ok, table
