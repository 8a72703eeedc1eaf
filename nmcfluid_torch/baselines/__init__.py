"""Comparison baselines on the Taylor-Green benchmark (port of
nmcfluid/baselines).

Rebuilds of the reference's experiments/ tree: INSR-PDE (implicit neural
spatial representation with a PINN pressure solve), pinnFluid (space-time
PINN), and piDeepONetSolver (physics-informed DeepONet). Each produces the
same per-frame TG velocity-error curve as the main method (BASELINE.md:
INSR 1.024e-3, PINN 3.951e-3, PI-DeepONet 3.945e-3):
`python -m nmcfluid_torch.baselines.run {insr,pinn,pideeponet}`, on the
card unless given `--device cpu`.
"""
from .insr import INSRFluid        # noqa: F401
from .pinn import PINNFluid        # noqa: F401
from .pideeponet import PIDeepONetFluid  # noqa: F401
