"""nmcfluid_torch — the neural Monte Carlo fluid solver in PyTorch + CUDA.

A port of `nmcfluid` (the JAX package beside it, which stays the
reference). Module paths and function names follow the JAX package, so
`nmcfluid_torch/wost/gen.py::estimate_solution_and_gradient_gen` is the
counterpart of `nmcfluid/wost/gen.py::estimate_solution_and_gradient_gen`.

It covers the frames of Taylor-Green, of the karman family (an open
channel with circle obstacles), of jpipe (a duct walked as a segment
soup) and of the four shipped 3D scenes (smoke, smoke_obs,
vortex_collide, karman3d: the closed cube): SIREN velocity
field (sine, relu, elu or tanh), Adam phase fits (the fused fit: a
hand-written CUDA kernel on the GPU, its plain PyTorch twin on the CPU;
or the fresh-batch loop), the divergence grid, the pressure solve (the
walk on stars with the generation executor, the DCT box solve with its
circle, cylinder and sphere corrections, the 2D boundary-element solve
or its Monte Carlo variant, boundary value caching), and the density
replay; beside the fluid, the whole 2D walk-on-stars family
(wost/solver.py: Dirichlet and Neumann data, double-sided walks, the
solution-only walk; wost/pool.py, the walker pool) and the scenes it
solves from files (scenes/images.py, scenes/custom.py). Entry points:

    python -m nmcfluid_torch.run <scene> [flags]     simulate, save, resume
    python -m nmcfluid_torch.replay <scene> {energy,vorticity,velocity}

each on the card unless given `--device cpu`; the port's benchmark is
`python3 -m nmcbench` (BENCHMARK.json at the root). Every flag of the JAX
CLI runs, the JAX package's measured negatives too (--fit_ensemble,
--adaptive_walks), default-off as there.
`wost/pallas_probe.py` measures the walk's table gather in the four forms
the TPU tried, each a hand-written CUDA kernel.

Precision: the SIREN's sin(30 z) layers amplify matmul rounding, and plain
bf16 matmuls failed the Taylor-Green error gate in the JAX package, so the
port runs in float32 and keeps TF32 off.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def get_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the GPU. Asking for the GPU
    where there is none raises: the CPU runs only when asked for by
    device="cpu", never in its place."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to run on the '
                           "CPU")
    return dev
