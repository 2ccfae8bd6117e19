"""Floor (uniform) dequantizer, the port of ``enflow_tpu/nn/floor.py``:
forward adds uniform noise scaled by ``dequant_scale`` and contributes no
log-density; reverse is ``floor``. The scale is static config
(``FlowConfig.dequant_scale``), not a parameter, so the dequantizer has no
parameters."""

import torch


def init_floor():
    return {}


def forward(scale, h, atom_mask, gen=None, noise=None):
    """``(z [B,N,nf], log_q [B] = 0)``. ``noise`` is the ``U[0, 1)`` draw
    when given (a test feeds the JAX package's), else it is drawn from
    ``gen``."""
    if noise is None:
        noise = torch.rand(h.shape, generator=gen, dtype=h.dtype,
                           device=h.device)
    z = h + scale * noise
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    return (torch.where(atom_mask[..., None], z, zero),
            torch.zeros((h.shape[0],), dtype=h.dtype, device=h.device))


def reverse(z, atom_mask):
    return torch.where(atom_mask[..., None], torch.floor(z),
                       torch.zeros((), dtype=z.dtype, device=z.device))
