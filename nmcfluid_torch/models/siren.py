"""SIREN coordinate networks on plain tensors (port of models/siren.py).

Parameters keep the JAX package's layout: a list of (W, b) with W of
shape (fan_in, fan_out), and each layer computes x @ W + b, so parameters
move between the packages unchanged (`params_from_numpy`). Hidden layers
are sin(30 z) by default, or relu, elu or tanh (networks.py:34-37); the
outermost layer is linear. Matmuls run in float32 (the
package turns TF32 off): the sin(30 z) layers amplify input rounding, and
plain bf16 failed the Taylor-Green error gate (nmcfluid/models/siren.py).
"""
import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

Params = List[Tuple[torch.Tensor, torch.Tensor]]

OMEGA_0 = 30.0  # networks.py:21


@dataclasses.dataclass(frozen=True)
class SirenConfig:
    in_features: int
    out_features: int
    num_hidden_layers: int = 2
    hidden_features: int = 128
    nonlinearity: str = "sine"       # sine | relu | elu | tanh
    normal_init_std: float = 0.1     # relu/tanh init: 2D 0.1, 3D 1.0


def _layer_dims(cfg: SirenConfig):
    dims = [cfg.in_features] + [cfg.hidden_features] * (
        cfg.num_hidden_layers + 1) + [cfg.out_features]
    return list(zip(dims[:-1], dims[1:]))


_ACTIVATIONS = {
    "sine": lambda z: torch.sin(OMEGA_0 * z),
    "relu": torch.relu,
    "elu": torch.nn.functional.elu,
    "tanh": torch.tanh,
}


def init_siren(key, cfg: SirenConfig, device="cpu") -> Params:
    """Initialization per nonlinearity (networks.py:78-96), zero biases,
    one key per layer from key.split, as the JAX package: sine takes
    U(-1/fan_in, 1/fan_in) in the first layer and U(+-sqrt(6/fan_in)/30)
    after; elu N(0, 1.5505/fan_in); relu and tanh N(0, normal_init_std^2).
    """
    if cfg.nonlinearity not in _ACTIVATIONS:
        raise ValueError(f"SIREN nonlinearity {cfg.nonlinearity!r}")
    dims = _layer_dims(cfg)
    params = []
    for i, ((fan_in, fan_out), k) in enumerate(zip(dims,
                                                   key.split(len(dims)))):
        shape = (fan_in, fan_out)
        if cfg.nonlinearity == "sine":
            bound = (1.0 / fan_in if i == 0
                     else math.sqrt(6.0 / fan_in) / OMEGA_0)
            w = k.uniform(shape, device, -bound, bound)
        elif cfg.nonlinearity == "elu":
            std = math.sqrt(1.5505188080679277) / math.sqrt(fan_in)
            w = std * k.normal(shape, device)
        else:
            w = cfg.normal_init_std * k.normal(shape, device)
        params.append((w, torch.zeros(fan_out, dtype=torch.float32,
                                      device=device)))
    return params


def apply_siren_features(params: Params, cfg: SirenConfig, x):
    """Penultimate activations (..., hidden_features): the input of the
    final linear layer."""
    act = _ACTIVATIONS[cfg.nonlinearity]
    h = x
    for w, b in params[:-1]:
        h = act(h @ w + b)
    return h


def apply_siren(params: Params, cfg: SirenConfig, x):
    """The network at x (..., in_features) -> (..., out_features)."""
    w, b = params[-1]
    return apply_siren_features(params, cfg, x) @ w + b


# d act(z) / dz times the tangent dz, in forward mode's order of operations
_TANGENTS = {
    "sine": lambda z, dz: torch.cos(OMEGA_0 * z) * (OMEGA_0 * dz),
    "relu": lambda z, dz: torch.where(z > 0, dz, 0.0),
    "elu": lambda z, dz: torch.where(z > 0, dz, torch.exp(z) * dz),
    "tanh": lambda z, dz: (1.0 - torch.tanh(z) ** 2) * dz,
}


def apply_siren_tangents(params: Params, cfg: SirenConfig, x):
    """The network at x (M, in_features) and its derivative along every
    input axis at once, by forward mode written out: (u (M, out), du
    (in, M, out)) with du[i] = d u / d x_i. Each layer carries the in
    tangents as one (in, M, hidden) batch, so the whole Jacobian costs one
    pass with no autograd bookkeeping."""
    act, tangent = _ACTIVATIONS[cfg.nonlinearity], _TANGENTS[cfg.nonlinearity]
    (w0, b0), *rest = params
    z = x @ w0 + b0
    dz = w0[:, None, :].expand(-1, x.shape[0], -1)      # d z / d x_i = W[i]
    for w, b in rest:
        h, dh = act(z), tangent(z, dz)
        z, dz = h @ w + b, dh @ w
    return z, dz


# d² act(z) along one axis, from z, its tangent dz and its second tangent d2z
_SECONDS = {
    "sine": lambda z, dz, d2z: OMEGA_0 * (
        torch.cos(OMEGA_0 * z) * d2z
        - OMEGA_0 * torch.sin(OMEGA_0 * z) * (dz * dz)),
    "relu": lambda z, dz, d2z: torch.where(z > 0, d2z, 0.0),
    "elu": lambda z, dz, d2z: torch.where(z > 0, d2z,
                                          torch.exp(z) * (d2z + dz * dz)),
    "tanh": lambda z, dz, d2z: (1.0 - torch.tanh(z) ** 2) * (
        d2z - 2.0 * torch.tanh(z) * (dz * dz)),
}


def apply_siren_second(params: Params, cfg: SirenConfig, x):
    """The network at x (M, in_features) with its first and unmixed second
    derivatives along every input axis, by forward mode written out:
    (u (M, out), du (in, M, out), d2u (in, M, out)) with d2u[i] =
    d² u / d x_i², so the Laplacian is d2u.sum(0). Each layer carries z,
    dz_i and d²z_ii; a linear layer maps all three by its W, and the
    nonlinearity h = act(z) gives d²h = act''(z) dz² + act'(z) d²z. Plain
    tensor ops, so autograd differentiates the result by the weights."""
    name = cfg.nonlinearity
    if name not in _SECONDS:
        raise NotImplementedError(
            f"apply_siren_second: no second derivative of {name!r}")
    act, tangent, second = _ACTIVATIONS[name], _TANGENTS[name], _SECONDS[name]
    (w0, b0), *rest = params
    z = x @ w0 + b0
    dz = w0[:, None, :].expand(-1, x.shape[0], -1)
    d2z = torch.zeros_like(dz)
    for w, b in rest:
        h, dh, d2h = act(z), tangent(z, dz), second(z, dz, d2z)
        z, dz, d2z = h @ w + b, dh @ w, d2h @ w
    return z, dz, d2z


def params_from_numpy(arrays, device="cpu") -> Params:
    """Convert the JAX package's parameters (a list of (W, b) arrays) to
    the port's float32 tensors on `device`."""
    return [(torch.tensor(np.asarray(w, np.float32), device=device),
             torch.tensor(np.asarray(b, np.float32), device=device))
            for w, b in arrays]

