"""SIREN coordinate networks on plain tensors (port of models/siren.py).

Parameters keep the JAX package's layout: a list of (W, b) with W of
shape (fan_in, fan_out), and each layer computes x @ W + b, so parameters
move between the packages unchanged (`params_from_numpy`). Hidden layers
are sin(30 z); the outermost layer is linear. Matmuls run in float32 (the
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
    nonlinearity: str = "sine"


def _layer_dims(cfg: SirenConfig):
    dims = [cfg.in_features] + [cfg.hidden_features] * (
        cfg.num_hidden_layers + 1) + [cfg.out_features]
    return list(zip(dims[:-1], dims[1:]))


def _check_sine(cfg: SirenConfig):
    if cfg.nonlinearity != "sine":
        raise NotImplementedError(
            f"SIREN nonlinearity {cfg.nonlinearity!r}: only 'sine' is ported")


def init_siren(key, cfg: SirenConfig, device="cpu") -> Params:
    """SIREN initialization (networks.py:78-90): first layer
    U(-1/fan_in, 1/fan_in), later layers U(+-sqrt(6/fan_in)/30), zero
    biases; one key per layer from key.split, as the JAX package."""
    _check_sine(cfg)
    dims = _layer_dims(cfg)
    params = []
    for i, ((fan_in, fan_out), k) in enumerate(zip(dims,
                                                   key.split(len(dims)))):
        bound = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / OMEGA_0
        w = k.uniform((fan_in, fan_out), device, -bound, bound)
        params.append((w, torch.zeros(fan_out, dtype=torch.float32,
                                      device=device)))
    return params


def apply_siren_features(params: Params, cfg: SirenConfig, x):
    """Penultimate activations (..., hidden_features): the input of the
    final linear layer."""
    _check_sine(cfg)
    h = x
    for w, b in params[:-1]:
        h = torch.sin(OMEGA_0 * (h @ w + b))
    return h


def apply_siren(params: Params, cfg: SirenConfig, x):
    """The network at x (..., in_features) -> (..., out_features)."""
    w, b = params[-1]
    return apply_siren_features(params, cfg, x) @ w + b


def params_from_numpy(arrays, device="cpu") -> Params:
    """Convert the JAX package's parameters (a list of (W, b) arrays) to
    the port's float32 tensors on `device`."""
    return [(torch.tensor(np.asarray(w, np.float32), device=device),
             torch.tensor(np.asarray(b, np.float32), device=device))
            for w, b in arrays]

