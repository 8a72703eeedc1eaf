"""The control of the check: the reference put in the program's place,
computed in TF32 (the precision below the configuration's float32 with
TF32 off), on the same questions a recorded frame asked. The check must
call it not correct."""

from . import frame as F
from .check import Record, cloud_valid, rebuild_head, rebuild_pool


def _phase(scene, phase, rec, out, prec):
    ph = dict(rec.phases[phase])
    out.phases[phase] = ph
    if phase == "prj":
        ph["prev"] = out.phases["adv"]["out"]
    x, A, c, t, w = rebuild_pool(scene, phase, out, prec)
    ph["pool"] = (x, A, c, t, w)
    ph["adam"] = F.adam_fit(ph["params0"], ph["pool"], ph["n_iters"],
                            ph["lr"], prec)
    batches = rebuild_head(scene, phase, out, prec)
    ph["head"] = [(b[0], b[3].float(), b[4]) for b in batches]
    cand, start, (lc, ls) = F.head_solve(ph["adam"], batches, prec)
    ph["out"] = [(W.float(), b.float()) for W, b in
                 (cand if lc <= ls else start)]


def control_record(scene, rec, prec="tf32"):
    """A Record whose answers are the reference's in `prec`, at rec's
    questions (its points, start weights and walk cloud)."""
    out = Record()
    out.prev, out.eps, out.t = rec.prev, rec.eps, rec.t
    out.projection = rec.projection
    out.pts = rec.pts
    out.valid, _ = cloud_valid(scene, rec)
    out.phases["adv"] = dict(rec.phases["adv"])
    _phase(scene, "adv", rec, out, prec)
    flat = F.grid_points(scene.box, scene.div_resolution, scene.dim,
                         rec.div.device).reshape(-1, scene.dim)
    div, _ = F.neg_divergence(scene, out.phases["adv"]["out"], flat, rec.eps,
                              rec.t, prec)
    out.div = div.float().reshape(rec.div.shape)
    p, g, _ = F.pressure(scene, out.div, rec.pts, out.valid, prec)
    out.p, out.grad_p = p.float(), g.float()
    _phase(scene, "prj", rec, out, prec)
    return out
