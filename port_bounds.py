"""The reference numbers behind chip_smoke.py's sanity bounds on the
karman and 3D paths: the JAX package's own CPU run of each scene at
reduced width.

    JAX_PLATFORMS=cpu python port_bounds.py karman karman3d vortex_collide
    JAX_PLATFORMS=cpu python port_bounds.py smoke smoke_obs --iters 10000

For each scene, with the JAX package (nmcfluid) on the CPU at the
scene's own batches (a smoke jet's thin shell is sampled at all only at
the full 128^2 points), a 64^2 pressure cloud x 64 walks, a divergence
grid of 32 cells on the longest side and 1000-iteration fits (--iters;
the shell is fitted only at the shipped 10,000), prints one JSON line of
the two readings chip_smoke.py bounds, both taken on the scene's
vel_vis grid over the free region: the fluid points where the hard
boundary conditions pin no component (c == 0 in the affine map u = A raw
+ c at the scene's ramp width), so that the field there is the network's.
The reference is the source's mean over the keys 0..63 of its jitter
(smoke's jet draws one; the other sources draw nothing). The readings:
the relative squared error of the field against it, and 0.5 mean|u|^2
over its, for the untrained weights, for a network that outputs zero (the
field is c), after add_source and after one step. chip_smoke.py's bounds
are set so that every trained run here passes them and the untrained and
the zero fields each cross one of them. This script imports JAX: it is a
check of the reference, not part of the port.
"""
import argparse
import json
import os
import time

import numpy as np

N_KEYS = 64         # draws averaged into the reference source


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="+")
    ap.add_argument("--iters", type=int, default=1000)
    args = ap.parse_args(argv)
    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim import sampling
    from nmcfluid.sim.fluid import _velocity_grid

    for name in args.scenes:
        t0 = time.time()
        scene = get_scene(name)
        f = NeuralFluid(scene, wost_resolution=64,
                        div_resolution=32, n_walks=64,
                        max_n_iters=args.iters)
        res = scene.vel_vis_resolution
        grid = sampling.uniform_grid(scene.scene_size, res, False)
        _, c = f.velocity_affine(grid, eps=scene.bdry_eps, t=0)
        c = np.asarray(c)
        free = np.asarray(scene.fluid_mask(grid)) & np.all(c == 0, -1)
        src = np.mean([np.asarray(scene.source_velocity(
            grid, key=jax.random.PRNGKey(k))) for k in range(N_KEYS)], 0)

        def field(state, t):
            return np.asarray(_velocity_grid(f, state.params, state.eps, t,
                                             res, False))

        def err(u):
            return float(np.sum((u - src)[free] ** 2)
                         / np.sum(src[free] ** 2))

        def ratio(u):
            return float(np.mean(np.sum(u[free] ** 2, -1))
                         / np.mean(np.sum(src[free] ** 2, -1)))

        s0 = f.init_state(0)
        s1 = f.add_source(s0)
        if name in ("karman", "karman2cyl", "karman3cyl"):
            s1 = s1._replace(eps=s1.eps / 2)     # nmcfluid/run.py:498-500
        s2 = f.step(s1)
        u0, u1, u2 = field(s0, 0), field(s1, 0), field(s2, 1)
        print(json.dumps({
            "scene": name, "free_points": int(free.sum()),
            "untrained_err": err(u0), "zero_err": err(c),
            "trained_err": err(u1), "untrained_ratio": ratio(u0),
            "zero_ratio": ratio(c), "after_source_ratio": ratio(u1),
            "after_step_ratio": ratio(u2), "seconds": time.time() - t0}),
            flush=True)

if __name__ == "__main__":
    main()
