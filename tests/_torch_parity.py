"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

`JaxKey` is the second implementation of the port's key seam
(nmcfluid_torch/utils/keys.py): it holds a `jax.random` key and replays
every split, fold_in and draw through jax.random, handing the numbers to
the port as torch tensors. With it the port walks the same random numbers
as the JAX package, so whole steps can be held against each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from nmcfluid_torch.ops.fastrand import seed_from_words

# one intra-op thread: the suite runs several xdist workers side by side
torch.set_num_threads(1)


class JaxKey:
    """Key object replaying jax.random (see the module docstring)."""

    def __init__(self, key):
        self.key = key

    @classmethod
    def from_seed(cls, seed):
        return cls(jax.random.PRNGKey(seed))

    def split(self, n=2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def uniform(self, shape, device, minval=0.0, maxval=1.0):
        u = jax.random.uniform(self.key, tuple(shape), jnp.float32,
                               minval, maxval)
        return torch.from_numpy(np.asarray(u).copy()).to(device)

    def randint(self, shape, lo, hi, device):
        r = jax.random.randint(self.key, tuple(shape), lo, hi)
        return torch.from_numpy(np.asarray(r).astype(np.int64)).to(device)

    def stream_seed(self):
        w0, w1 = (int(v) for v in np.asarray(
            jax.random.key_data(self.key)).astype(np.uint32))
        return seed_from_words(w0, w1)


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def params_np(params):
    """A parameter list of either package as a flat list of numpy arrays."""
    return [to_np(a) for pair in params for a in pair]
