"""Per-timestep checkpoints of the velocity network (port of
nmcfluid/utils/checkpoint.py), in the JAX package's npz layout: one file
per step, `ckpt_step_t{NNN}.npz`, holding the parameter leaves in order
(W0, b0, W1, b1, ...) as `leaf_{i}` plus the `timestep`. A checkpoint
written by either package loads in the other.
"""
import os
import re

import numpy as np
import torch


def _path(model_dir, step_or_name):
    if isinstance(step_or_name, int):
        return os.path.join(model_dir, f"ckpt_step_t{step_or_name:03d}.npz")
    return os.path.join(model_dir, f"ckpt_{step_or_name}.npz")


def save_ckpt(model_dir, params, timestep, name=None):
    """base.py:102-115. Saves the leaves in order + the timestep."""
    os.makedirs(model_dir, exist_ok=True)
    leaves = [t for pair in params for t in pair]
    path = _path(model_dir, name if name is not None else int(timestep))
    np.savez(path, timestep=int(timestep),
             **{f"leaf_{i}": t.detach().cpu().numpy()
                for i, t in enumerate(leaves)})
    return path


def load_ckpt(model_dir, params_like, step_or_name):
    """base.py:117-127. Returns (params, timestep); `params_like` gives the
    structure and the device."""
    dev = params_like[0][0].device
    n = 2 * len(params_like)
    with np.load(_path(model_dir, step_or_name)) as z:
        leaves = [torch.as_tensor(z[f"leaf_{i}"], device=dev)
                  for i in range(n)]
        t = int(z["timestep"])
    return [(leaves[2 * i], leaves[2 * i + 1])
            for i in range(len(params_like))], t



def latest_step(model_dir):
    """Highest saved step number, or -1."""
    best = -1
    if not os.path.isdir(model_dir):
        return best
    for f in os.listdir(model_dir):
        m = re.match(r"ckpt_step_t(\d+)\.npz$", f)
        if m:
            best = max(best, int(m.group(1)))
    return best
