"""Both packages' baseline runners on the CPU at a small size, to tell the
port's algorithm from its draws.

    JAX_PLATFORMS=cpu python port_baselines.py pideeponet [--seeds 0 1 2]
        [--max_n_iters N] [--hidden H] [--layers L] [--sample_resolution R]
        [--frames F] [--grid G] [--out DIR]

Runs nmcfluid.baselines.run and nmcfluid_torch.baselines.run (--device
cpu) with the same flags and nets of L x H, the port four times: with its
key seam replaying jax.random (tests/_torch_parity.JaxKey), so both
packages draw the same points (`port_jax_draws`); with its own key
(utils/keys.py), which draws others (`port_own_key`); and twice mixed,
the model's initial weights from one key class and the training's
collocation and boundary draws from the other (`port_jax_init_own_draws`,
`port_own_init_jax_draws`). Each seed s shifts every root key the runners
make (their seed 0) to s. Prints each run's honest and refpipe means: if
the replaying run tracks JAX seed by seed, and the port's own key falls
within the spread of JAX's seeds, the draws make the difference, not the
port; the mixed runs tell which draws.
"""
import argparse
import functools
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("method", choices=["insr", "pinn", "pideeponet"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--max_n_iters", type=int, default=2000)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--sample_resolution", type=int, default=16)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--grid", type=int, default=50)
    ap.add_argument("--out", default="results_port_baselines")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import jax
    import pytest
    from _torch_parity import JaxKey

    import nmcfluid.baselines.run as jrun
    import nmcfluid_torch.baselines.run as trun
    from nmcfluid_torch.utils.keys import Key

    def init_from(init, key_cls):
        """A model's init drawing its weights from key_cls, whatever key
        the runner hands it (the runner's root key, seed 0)."""
        return lambda self, seed=0, key=None: init(
            self, key=key_cls.from_seed(0))
    models = [getattr(trun, name)
              for name in ("INSRFluid", "PINNFluid", "PIDeepONetFluid")]
    inits = [cls.init for cls in models]

    flags = [args.method, "--max_n_iters", str(args.max_n_iters),
             "--sample_resolution", str(args.sample_resolution),
             "--frames", str(args.frames), "--grid", str(args.grid)]
    net = dict(num_hidden_layers=args.layers, hidden_features=args.hidden)
    runs = {}
    prng_key, key_seed = jax.random.PRNGKey, Key.from_seed.__func__
    for seed in args.seeds:
        with pytest.MonkeyPatch.context() as mp:
            for module in (jrun, trun):
                for name in ("INSRFluid", "PINNFluid", "PIDeepONetFluid"):
                    mp.setattr(module, name, functools.partial(
                        getattr(module, name), **net))
            mp.setattr(jax.random, "PRNGKey",
                       lambda s, _s=seed: prng_key(s + _s))
            mp.setattr(Key, "from_seed", classmethod(
                lambda cls, s, _s=seed: key_seed(cls, s + _s)))
            for tag, key, init_key in (
                    ("jax", None, None), ("port_jax_draws", JaxKey, JaxKey),
                    ("port_own_key", Key, Key),
                    ("port_jax_init_own_draws", Key, JaxKey),
                    ("port_own_init_jax_draws", JaxKey, Key)):
                out = os.path.join(args.out, f"{tag}_s{seed}")
                if key is None:
                    jrun.main(flags + ["--out", out])
                else:
                    mp.setattr(trun, "Key", key)
                    for cls, init in zip(models, inits):
                        mp.setattr(cls, "init", init_from(init, init_key))
                    trun.main(flags + ["--out", out, "--device", "cpu"])
                runs[tag, seed] = [np.loadtxt(os.path.join(
                    out, f"error_{args.method}{suffix}.txt"))
                    for suffix in ("", "_refpipe")]
    for (tag, seed), (honest, refpipe) in sorted(runs.items()):
        print(f"{args.method} seed {seed} {tag}: honest mean "
              f"{honest.mean():.6e}, refpipe mean {refpipe.mean():.6e}",
              flush=True)

if __name__ == "__main__":
    main()
