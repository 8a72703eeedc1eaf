"""Read the port's own-key Monte Carlo checks over many keys.

    JAX_PLATFORMS=cpu python port_key_audit.py NODEID [NODEID ...]
        [--classes port jax] [--keys 0 1 ... 11] [--jobs N]
        [--out FILE.json]
    python port_key_audit.py --chip_smoke stage mixed2d image mixed3d
        [--keys ...] [--out FILE.json]                        (card)

Runs each test (a pytest node id under tests/) once per key class and key
shift k: every key the test makes as Key(s), and every key the fluid makes
from a seed s (init_state), becomes the class's key for seed s + k:
`port` is the port's key (nmcfluid_torch/utils/keys.py), `jax` the
JAX-replay key (tests/_torch_parity.JaxKey of jax.random.PRNGKey(s + k)).
k = 0 under `port` is the test's own draw. While a test runs, the Monte
Carlo checks of tests/_torch_parity.py (mc_close, mc_below, mc_band)
record the share of their tolerance each reading takes instead of
raising; a plain assert still fails the run. Prints, for each test and
class, the worst share over the keys with the check and key that took
it, and the keys whose run failed; writes every reading to --out. A worst
share above 0.8 means the check has too few walks or samples for its
tolerance. docs/key_audit_torch_r16.json holds the readings that sized
the checks (its `repaired` class is `port`; its `parent` class, the seam
whose draws kept the low 32 bits of a key, is gone from the code).

--chip_smoke reads chip_smoke.py's own-key checks on the card the same
way, under the port's key (no JAX there), one call a check and key:
`stage` its tg_stage_check (the error one Taylor-Green step adds at full
width over the JAX package's, band [0.5, 2]), `mixed2d`, `image` and
`mixed3d` its walks against manufactured solutions at the JAX tests'
atol, each torch.testing.assert_close recorded as the largest |a - b| /
(atol + rtol |b|). The fit-kernel checks whose initial weights come from
a key are read by `python -m nmcfluid_torch.sim.fitprobe --key_sweep 12`.
"""
import argparse
import json
import multiprocessing
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


class Shifted:
    """Stands in for the `Key` class: seed s -> make(s + shift)."""

    def __init__(self, make, shift):
        self.make, self.shift = make, shift

    def __call__(self, seed=0):
        return self.make(int(seed) + self.shift)

    def from_seed(self, seed):
        return self(seed)


def _maker(cls_name):
    if cls_name == "port":
        from nmcfluid_torch.utils.keys import Key
        return Key
    from _torch_parity import JaxKey
    return JaxKey.from_seed


class _Plugin:
    def __init__(self, cls_name, shift):
        self.cls_name, self.shift, self.out = cls_name, shift, {}

    def pytest_runtest_setup(self, item):
        import pytest

        import _torch_parity
        import nmcfluid_torch.sim.fluid as tfluid
        self.mp = pytest.MonkeyPatch()
        key = Shifted(_maker(self.cls_name), self.shift)
        for module in (item.module, tfluid):
            if hasattr(module, "Key"):
                self.mp.setattr(module, "Key", key)
        self.readings = []
        self.mp.setattr(_torch_parity, "AUDIT", self.readings)

    def pytest_runtest_makereport(self, item, call):
        if call.when == "call":
            self.out[item.nodeid] = dict(
                readings=list(self.readings),
                failed=None if call.excinfo is None
                else call.excinfo.exconly()[:300])

    def pytest_runtest_teardown(self, item):
        self.mp.undo()


def _chip_run(names, keys):
    """{"chip_smoke.py::" + name: {"port": {k: result}}} on the card."""
    import chip_smoke as cs
    import nmcfluid_torch.sim.fluid as tfluid
    from nmcfluid_torch.scenes import get_scene
    from nmcfluid_torch.utils.keys import Key
    checks = {"mixed2d": cs._mixed_boundary_checks,
              "image": cs._image_scene_check, "mixed3d": cs._mixed3d_checks}
    fluid = (tfluid.NeuralFluid(get_scene("taylorgreen"), device="cuda")
             if "stage" in names else None)
    assert_close = torch.testing.assert_close
    table = {}
    for name in names:
        for k in keys:
            key = Shifted(Key, k)
            readings = []

            def recording(a, b, rtol=None, atol=None, **kw):
                if atol is None:
                    return assert_close(a, b, rtol=rtol, atol=atol, **kw)
                bound = atol + (rtol or 0.0) * b.abs()
                readings.append((f"#{len(readings)}, atol {atol:g}",
                                 float(((a - b).abs() / bound).max())))
            torch.testing.assert_close = recording
            tfluid.Key = key
            failed = None
            try:
                if name == "stage":
                    for what, (d, jd) in cs.tg_stage_readings(
                            fluid, key(0)).items():
                        r = d / jd
                        readings.append((what, r - 1.0 if r >= 1.0
                                         else (1.0 - r) / 0.5))
                else:
                    checks[name](key)
            except AssertionError as e:
                failed = str(e)[:300]
            finally:
                torch.testing.assert_close = assert_close
                tfluid.Key = Key
            table.setdefault(f"chip_smoke.py::{name}", {}).setdefault(
                "port", {})[k] = dict(readings=readings, failed=failed)
            print(f"{name} key {k}: {readings} failed {failed}", flush=True)
    return table


def _run(task):
    cls_name, shift, nodeids = task
    import pytest
    plugin = _Plugin(cls_name, shift)
    pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                 "--rootdir", ROOT] + nodeids, plugins=[plugin])
    return cls_name, shift, plugin.out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("nodeids", nargs="*")
    ap.add_argument("--chip_smoke", nargs="+", default=[],
                    choices=["stage", "mixed2d", "image", "mixed3d"])
    ap.add_argument("--classes", nargs="+", default=["port", "jax"],
                    choices=["port", "jax"])
    ap.add_argument("--keys", type=int, nargs="+", default=list(range(12)))
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    tasks = [(c, k, args.nodeids) for c in args.classes for k in args.keys
             if args.nodeids]
    if args.chip_smoke:
        if not torch.cuda.is_available():
            raise SystemExit("--chip_smoke needs the card")
        sys.path.insert(0, ROOT)
        results = []
        args.classes = ["port"]
        table = _chip_run(args.chip_smoke, args.keys)
    elif args.jobs > 1:
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            results = pool.map(_run, tasks, chunksize=1)
    else:
        results = [_run(t) for t in tasks]
    if not args.chip_smoke:
        table = {}
    for cls_name, shift, out in results:
        for nodeid, res in out.items():
            table.setdefault(nodeid, {}).setdefault(cls_name, {})[shift] = res
    for nodeid in sorted(table):
        for cls_name in args.classes:
            runs = table[nodeid].get(cls_name, {})
            worst = max(((share, what, k) for k, r in runs.items()
                         for what, share in r["readings"]), default=None)
            failed = sorted(k for k, r in runs.items() if r["failed"])
            print(f"{nodeid} [{cls_name}] worst share "
                  + (f"{worst[0]:.3f} ({worst[1]}, key {worst[2]})"
                     if worst else "none")
                  + f", keys read {len(runs)}, failed {failed}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
