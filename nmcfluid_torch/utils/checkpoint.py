"""Per-timestep checkpoints of the velocity network (port of
nmcfluid/utils/checkpoint.py), in the JAX package's npz layout: one file
per step, `ckpt_step_t{NNN}.npz`, holding the parameter leaves in
jax.tree_util's order as `leaf_{i}` plus the `timestep`: a list of (W, b)
layers gives W0, b0, W1, b1, ...; a dict gives its values by sorted key
(the baselines' INSR state dict(vel=..., p=...) saves p's leaves before
vel's). A checkpoint written by either package loads in the other.
"""
import os
import re

import numpy as np
import torch


def _path(model_dir, step_or_name):
    if isinstance(step_or_name, int):
        return os.path.join(model_dir, f"ckpt_step_t{step_or_name:03d}.npz")
    return os.path.join(model_dir, f"ckpt_{step_or_name}.npz")


def tree_leaves(tree):
    """The tensors of a nest of dicts, lists and tuples in
    jax.tree_util.tree_leaves's order: dict values by sorted key."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like, leaves):
    """`leaves` (in tree_leaves's order) in the structure of `like`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)
    return build(like)


def save_ckpt(model_dir, params, timestep, name=None):
    """base.py:102-115. Saves the leaves in tree order + the timestep."""
    os.makedirs(model_dir, exist_ok=True)
    leaves = tree_leaves(params)
    path = _path(model_dir, name if name is not None else int(timestep))
    np.savez(path, timestep=int(timestep),
             **{f"leaf_{i}": t.detach().cpu().numpy()
                for i, t in enumerate(leaves)})
    return path


def load_ckpt(model_dir, params_like, step_or_name):
    """base.py:117-127. Returns (params, timestep); `params_like` gives the
    structure and the device."""
    like = tree_leaves(params_like)
    with np.load(_path(model_dir, step_or_name)) as z:
        leaves = [torch.as_tensor(z[f"leaf_{i}"], device=like[0].device)
                  for i in range(len(like))]
        t = int(z["timestep"])
    return tree_unflatten(params_like, leaves), t


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
