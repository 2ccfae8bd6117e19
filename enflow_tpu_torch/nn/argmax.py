"""ArgMax flow dequantizer for one-hot atom-type features, the port of
``enflow_tpu/nn/argmax.py``::

    net_out = MLP(h);  log_scale, translate = split(net_out)
    u       = translate + eps * exp(log_scale)
    log_q   = log_gaussian(u) - sum(log_scale)
    T       = sum(h * u, -1)
    z       = h*u + (1-h)*(T - softplus(T-u))
    log_q  -= sum((1-h) * logsigmoid(T-u))
    reverse(z) = one_hot(argmax(z))

Mask-aware (padded atoms give ``z = 0`` and no ``log_q``), per-molecule
``log_q`` with the ``log(2 pi)`` constant charged once per molecule.
"""

import torch

from .. import resolve_device
from ..utils.helpers import log_gaussian_per_mol
from .mlp import init_mlp, apply_mlp


def init_argmax(gen: torch.Generator, node_nf: int, hidden_nf: int,
                dtype=torch.float32, device=None):
    # network: Linear(nf->hidden), SiLU, Linear(hidden->2nf)
    return {"network": init_mlp(gen, [node_nf, hidden_nf, 2 * node_nf],
                                dtype, resolve_device(device))}


def _softplus(x):
    """``log(1 + e^x)`` without a threshold (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def forward(params, h, atom_mask, gen=None, eps=None):
    """Dequantize one-hot ``h [B,N,nf]``: ``(z [B,N,nf], log_q [B])``. The
    noise is ``eps`` when given (a test feeds the JAX package's draw), else
    a standard normal draw from ``gen``."""
    am = atom_mask[..., None]
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    net_out = apply_mlp(params["network"], h)
    log_scale, translate = torch.chunk(net_out, 2, dim=-1)
    if eps is None:
        eps = torch.randn(h.shape, generator=gen, dtype=h.dtype,
                          device=h.device)
    u = translate + eps * torch.exp(log_scale)
    log_q = (log_gaussian_per_mol(u, atom_mask)
             - torch.where(am, log_scale, zero).sum(dim=(1, 2)))
    T = (h * u).sum(-1, keepdim=True)
    z = h * u + (1.0 - h) * (T - _softplus(T - u))
    ldj = (1.0 - h) * -_softplus(u - T)                  # log_sigmoid(T - u)
    log_q = log_q - torch.where(am, ldj, zero).sum(dim=(1, 2))
    return torch.where(am, z, zero), log_q


def reverse(z, atom_mask):
    """Re-quantize: one-hot of the argmax, zero on padded atoms."""
    oh = torch.nn.functional.one_hot(z.argmax(dim=-1), z.shape[-1]).to(
        z.dtype)
    return torch.where(atom_mask[..., None], oh,
                       torch.zeros((), dtype=z.dtype, device=z.device))
