"""A SIREN velocity field in plain PyTorch: layers x @ W + b, sin(30 z)
after every layer but the last (Sitzmann et al. 2020), parameters as a
list of (W (fan_in, fan_out), b), the layout the program keeps."""
import math

import torch

OMEGA_0 = 30.0


def layer_dims(d_in, d_out, hidden, layers):
    dims = [d_in] + [hidden] * (layers + 1) + [d_out]
    return list(zip(dims[:-1], dims[1:]))


def init(generator, d_in, d_out, hidden, layers, device):
    """SIREN's initialisation in one draw on the device: U(-1/fan_in,
    1/fan_in) in the first layer and U(+-sqrt(6/fan_in)/30) after it,
    zero biases."""
    dims = layer_dims(d_in, d_out, hidden, layers)
    n = sum(a * b for a, b in dims)
    u = torch.rand(n, generator=generator, device=device) * 2.0 - 1.0
    params, o = [], 0
    for i, (a, b) in enumerate(dims):
        bound = 1.0 / a if i == 0 else math.sqrt(6.0 / a) / OMEGA_0
        params.append((u[o:o + a * b].view(a, b) * bound,
                       torch.zeros(b, device=device)))
        o += a * b
    return params


def cast(params, dtype):
    return [(W.to(dtype), b.to(dtype)) for W, b in params]


def features(params, x):
    """The last hidden layer's activations (the head solve's features)."""
    h = x
    for W, b in params[:-1]:
        h = torch.sin(OMEGA_0 * (h @ W + b))
    return h


def forward(params, x):
    W, b = params[-1]
    return features(params, x) @ W + b
