"""Linear layers and MLPs as plain parameter dicts, the port of
``enflow_tpu/nn/mlp.py``.

Layout matches the JAX package: ``{'w': [in, out], 'b': [out]}`` per layer,
a list of layers per MLP. Initialization uses torch's ``nn.Linear`` bounds,
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, drawn from an explicit generator
(on the CPU, then moved, so a seed gives the same weights on every device).
"""

import math

import torch
import torch.nn.functional as Fn

from .. import resolve_device


def silu(x: torch.Tensor) -> torch.Tensor:
    return Fn.silu(x)


def _uniform(gen, shape, bound, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return ((2.0 * u - 1.0) * bound).to(dtype=dtype, device=device)


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, device=None, bias: bool = True,
                init: str = "torch", gain: float = 1.0):
    """Linear-layer params ``{'w': [in, out], 'b': [out]?}`` on ``device``
    (``cuda`` unless the caller asks for another)."""
    device = resolve_device(device)
    if init == "torch":
        bound = 1.0 / math.sqrt(in_dim)
    elif init == "xavier_uniform":
        bound = gain * math.sqrt(6.0 / (in_dim + out_dim))
    else:
        raise ValueError(init)
    params = {"w": _uniform(gen, (in_dim, out_dim), bound, dtype, device)}
    if bias:
        params["b"] = _uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim),
                               dtype, device)
    return params


def apply_linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def init_mlp(gen: torch.Generator, dims, dtype=torch.float32, device=None):
    """MLP params: a list of linear layers for ``dims = [in, ..., out]``."""
    device = resolve_device(device)
    return [init_linear(gen, dims[i], dims[i + 1], dtype, device)
            for i in range(len(dims) - 1)]


def apply_mlp(params, x: torch.Tensor, act=silu, final_act=None):
    """Apply an MLP: activation between layers, optional final activation."""
    for i, layer in enumerate(params):
        x = apply_linear(layer, x)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x
