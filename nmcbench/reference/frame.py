"""The reference's side of one frame of the neural Monte Carlo fluid
(Jain et al., "Neural Monte Carlo Fluid Simulation"): the advection fit's
targets u_prev(clamp(x - u_prev(x) dt)), the projection fit's targets
u_prev(x) - grad p(x), a phase fit of Adam iterations over a pool of
minibatches cycled as batch i % K, the closed-form least-squares head,
the divergence grid -div u_prev, and the pressure at a cloud.

Every function takes the precision it runs in (`prec`, see
precision.py) and the configuration's reference scene (`Scene`), whose
module decides the geometry (configs/__init__.py); its boundary
conditions are affine in the network's raw output."""
import torch

from . import siren
from .precision import dtype, matmul

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Scene:
    """A configuration file's scene and its plain reference module
    (configs/<name>.py), which decides the geometry: the hard boundary
    conditions, the fluid's points, the back trace's clamp, the distance
    to the boundary and the pressure solve."""

    def __init__(self, cfg, module):
        self.cfg, self.mod = cfg, module
        sf = cfg["scene_fields"]
        self.box = tuple(sf["scene_size"])
        self.dim = sf["dim"]
        self.dt = sf["dt"]
        self.mask = sf["boundary_distance_mask"]
        self.div_resolution = cfg["fluid"]["div_resolution"]

    def affine(self, x, eps, t):
        return self.mod.affine(x, self.cfg, eps, t)

    def fluid_mask(self, x):
        return self.mod.fluid_mask(x, self.cfg)

    def clamp_back(self, x):
        return self.mod.clamp_back(x, self.cfg)

    def wall_distance(self, x):
        return self.mod.wall_distance(x, self.cfg)

    def velocity(self, params, x, eps, t):
        """(u, drawn): the velocity with the hard BCs at x, and the points
        whose value the program draws at random (u there is not known)."""
        A, c, drawn = self.affine(x, eps, t)
        raw = siren.forward(params, x)
        return torch.einsum("...de,...e->...d", A, raw) + c, drawn


def blocks(n, size):
    for a in range(0, n, size):
        yield slice(a, min(a + size, n))


# ---------------------------------------------------------------- targets

def advect_pool(scene, prev, x, eps, t, prec):
    """(A, c, target, drawn) of advection points x (..., D)."""
    dt_ = dtype(prec)
    p = siren.cast(prev, dt_)
    x = x.to(dt_)
    with matmul(prec):
        u, d1 = scene.velocity(p, x, eps, t)
        back = scene.clamp_back(x - u * scene.dt)
        adv, d2 = scene.velocity(p, back, eps, t)
        A, c, _ = scene.affine(x, eps, t)
    return A, c, adv, d1 | d2


def project_pool(scene, prev, x, grad_at_x, eps, t, prec):
    """(A, c, target, drawn) of projection points x with the pressure
    gradient grad_at_x there."""
    dt_ = dtype(prec)
    x = x.to(dt_)
    with matmul(prec):
        u, drawn = scene.velocity(siren.cast(prev, dt_), x, eps, t)
        A, c, _ = scene.affine(x, eps, t)
    return A, c, u - grad_at_x.to(dt_), drawn


def _keys(x):
    """An int64 key of each float32 point's bit pattern (a wrapping
    polynomial hash over its coordinates)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    k = bits[..., 0]
    for i in range(1, x.shape[-1]):
        k = k * 0x100000001B3 + bits[..., i]
    return k


def cloud_index(cloud, x):
    """(idx, found): the index in `cloud` (N, D) of each point of x (...,
    D), matched bit for bit."""
    ck = _keys(cloud)
    order = torch.argsort(ck)
    sk = ck[order]
    q = _keys(x)
    pos = torch.clamp(torch.searchsorted(sk, q), max=sk.numel() - 1)
    idx = order[pos]
    found = torch.all(cloud[idx] == x, dim=-1)
    return idx, found


# -------------------------------------------------------------------- fits

def _flat(params):
    return torch.cat([t.reshape(-1) for pair in params for t in pair])


def _unflat(flat, like):
    out, o = [], 0
    for W, b in like:
        nw, nb = W.numel(), b.numel()
        out.append((flat[o:o + nw].view(W.shape),
                    flat[o + nw:o + nw + nb].view(b.shape)))
        o += nw + nb
    return out


def adam_fit(params0, pool, n_iters, lr, prec="f32"):
    """n_iters Adam iterations (optax's formula) from params0 on the
    pool (x, A, c, target, w), batch i % K at iteration i, minimising
    sum w |A raw + c - target|^2 / (max(sum w, 1) D). float32 ("f32",
    TF32 off) or "tf32". On a CUDA device one iteration is captured as a
    CUDA graph and replayed; elsewhere it runs eagerly. Returns params."""
    x, A, c, tgt, w = (a.to(torch.float32).contiguous() for a in pool)
    K, D = x.shape[0], c.shape[-1]
    norm = torch.clamp(w.sum(dim=1), min=1.0) * D
    flat = _flat(params0).to(torch.float32).clone()
    start = flat.clone()
    m, v = torch.zeros_like(flat), torch.zeros_like(flat)
    it = torch.zeros(1, dtype=torch.int64, device=flat.device)
    b1 = torch.tensor(ADAM_B1, dtype=torch.float32, device=flat.device)
    b2 = torch.tensor(ADAM_B2, dtype=torch.float32, device=flat.device)

    def step():
        j = torch.remainder(it, K)
        with torch.enable_grad():
            fp = flat.detach().requires_grad_(True)
            p = _unflat(fp, params0)
            raw = siren.forward(p, x.index_select(0, j)[0])
            u = torch.einsum("nde,ne->nd", A.index_select(0, j)[0], raw) \
                + c.index_select(0, j)[0]
            se = torch.sum((u - tgt.index_select(0, j)[0]) ** 2, dim=-1)
            loss = torch.sum(w.index_select(0, j)[0] * se) \
                / norm.index_select(0, j)[0]
            g, = torch.autograd.grad(loss, fp)
        it.add_(1)
        n = it.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, n)
        bc2 = 1.0 - torch.pow(b2, n)
        m.copy_((1.0 - ADAM_B1) * g + ADAM_B1 * m)
        v.copy_((1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v)
        flat.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)))

    with matmul(prec), torch.no_grad():
        if not flat.is_cuda:
            for _ in range(n_iters):
                step()
            return _unflat(flat, params0)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        flat.copy_(start)
        m.zero_()
        v.zero_()
        it.zero_()
        for _ in range(n_iters):
            graph.replay()
        torch.cuda.synchronize()
        out = _unflat(flat.clone(), params0)
        del graph
    return out


def batch_loss(params, batch):
    x, A, c, tgt, w = batch
    raw = siren.forward(params, x)
    u = torch.einsum("nde,ne->nd", A, raw) + c
    se = torch.sum((u - tgt) ** 2, dim=-1)
    return torch.sum(w * se) / (torch.clamp(torch.sum(w), min=1.0)
                                * c.shape[-1])


def head_solve(params, batches, prec="f64"):
    """The closed-form finish of a phase fit: the last layer's change by
    weighted least squares over batches[:-1] with the trunk fixed, by an
    eigendecomposition of the normal equations with a 1e-5 relative
    cutoff; batches[-1] decides whether the solve helped. Returns
    (candidate, start, (candidate loss, start loss)) in `prec`."""
    dt_ = dtype(prec)
    p = siren.cast(params, dt_)
    W, b = p[-1]
    h1, D = W.shape[0] + 1, W.shape[1]
    dev = W.device
    M = torch.zeros((h1, D, h1, D), dtype=dt_, device=dev)
    rhs = torch.zeros((h1, D), dtype=dt_, device=dev)
    with matmul(prec), torch.no_grad():
        for x, A, c, tgt, w in batches[:-1]:
            x, A, c, tgt, w = (a.to(dt_) for a in (x, A, c, tgt, w))
            phi = siren.features(p, x)
            phi1 = torch.cat([phi, torch.ones_like(phi[:, :1])], -1)
            y = tgt - (torch.einsum("nde,ne->nd", A, phi @ W + b) + c)
            G = torch.einsum("nde,ndf->nef", A, A)
            Ay = torch.einsum("nde,nd->ne", A, y)
            for e in range(D):
                rhs[:, e] += phi1.T @ (w * Ay[:, e])
                for f in range(D):
                    M[:, e, :, f] += (phi1 * (w * G[:, e, f])[:, None]).T \
                        @ phi1
        n = h1 * D
        evals, evecs = torch.linalg.eigh(M.reshape(n, n))
        lmax = torch.clamp(evals[-1], min=1e-30)
        inv = torch.where(evals > 1e-5 * lmax,
                          1.0 / torch.maximum(evals, 1e-5 * lmax),
                          torch.zeros_like(evals))
        delta = (evecs @ (inv * (evecs.T @ rhs.reshape(n)))).reshape(h1, D)
        cand = p[:-1] + [(W + delta[:-1], b + delta[-1])]
        last = tuple(a.to(dt_) for a in batches[-1])
        losses = (float(batch_loss(cand, last)), float(batch_loss(p, last)))
    return cand, p, losses


# ------------------------------------------------------- divergence, solve

def grid_points(box_, resolution, dim, device):
    """The cell-centred grid over the box whose longest edge has
    `resolution` cells and every other edge as many as its length
    rounds to (the published method's model_utils.py), its coordinates
    computed in float32 as the program's grid is (the questions are the
    same points): (n_1, ..., n_dim, dim)."""
    ext = [box_[2 * i + 1] - box_[2 * i] for i in range(dim)]
    axes = []
    for i in range(dim):
        n = max(1, int(round(resolution * ext[i] / max(ext))))
        a = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
        axes.append(box_[2 * i] + a * ext[i])
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def neg_divergence(scene, prev, pts, eps, t, prec, block=1 << 17):
    """(-div u_prev at pts (N, D), drawn (N,)) by reverse-mode
    differentiation, in blocks."""
    dt_ = dtype(prec)
    p = siren.cast(prev, dt_)
    outs, drawn = [], []
    with matmul(prec):
        for s in blocks(pts.shape[0], block):
            with torch.enable_grad():
                x = pts[s].to(dt_).requires_grad_(True)
                u, d = scene.velocity(p, x, eps, t)
                div = 0.0
                for i in range(scene.dim):
                    g, = torch.autograd.grad(u[:, i].sum(), x,
                                             retain_graph=i + 1 < scene.dim)
                    div = div + g[:, i]
            outs.append(-div.detach())
            drawn.append(d)
    return torch.cat(outs), torch.cat(drawn)


def pressure(scene, div_grid, pts, valid, prec):
    """(p, grad p, band) at pts: the configuration's pressure solve of
    div_grid (its right-hand side -div u), zeroed as the method masks
    them (p and grad p within the mask distance of the boundary, grad p
    also outside the domain or at a point outside the fluid, `valid`
    False). `band` marks points within 1e-6 of the mask distance, where
    float32 and float64 may decide the mask differently."""
    dt_ = dtype(prec)
    y = pts.to(dt_)
    p, g = scene.mod.pressure(div_grid, y, scene.cfg, dt_)
    dist, outside = scene.wall_distance(y)
    near = dist < scene.mask
    p = torch.where(near, 0.0, p)
    bad = near | outside | ~valid
    g = torch.where(bad[:, None], 0.0, g)
    band = torch.abs(dist - scene.mask) < 1e-6
    return p, g, band
