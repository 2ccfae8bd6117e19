"""Trajectory analysis observables, the port of
``enflow_tpu/sim/analysis.py``: the radial distribution function, to check
the LJ latent sampler against known fluid structure and generated
configurations against MD."""

from __future__ import annotations

import math

import torch


def radial_distribution(pos, box, r_max, n_bins: int = 100, mask=None):
    """g(r) over a trajectory under the minimum-image convention.

    ``pos [F, N, 3]`` frames (or ``[N, 3]``), ``box [3]``, ``r_max <=
    min(box) / 2``, ``mask [N]`` real atoms (optional). Returns
    ``(r_centers [n_bins], g [n_bins])``, normalized so an ideal gas gives
    g(r) = 1: each i < j pair counted once against ``(N_real (N_real - 1)
    / 2) * shell_volume / box_volume`` per frame. The histogram has
    ``jnp.histogram``'s bins: ``[e_k, e_k+1)``, the last one closed."""
    pos = torch.as_tensor(pos)
    if pos.ndim == 2:
        pos = pos[None]
    F, N, _ = pos.shape
    dt, dev = pos.dtype, pos.device
    box = torch.as_tensor(box, dtype=dt, device=dev)
    if mask is None:
        mask = torch.ones((N,), dtype=torch.bool, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    n_real = mask.sum().to(dt)

    iu = torch.triu(torch.ones((N, N), dtype=torch.bool, device=dev),
                    diagonal=1)
    pair_mask = iu & mask[:, None] & mask[None, :]
    edges = torch.linspace(0.0, float(r_max), n_bins + 1,
                           dtype=torch.float64).to(device=dev, dtype=dt)

    d = pos[:, :, None, :] - pos[:, None, :, :]
    d = d - torch.round(d / box) * box
    # invalid pairs get r = inf, past the last edge
    r = torch.sqrt(torch.where(pair_mask, (d * d).sum(-1),
                               torch.full((), math.inf, dtype=dt,
                                          device=dev)))
    # searchsorted on the right, the last edge inside the last bin
    b = torch.searchsorted(edges, r.reshape(-1), right=True)
    b = torch.where(r.reshape(-1) == edges[-1], n_bins, b)
    hist = torch.bincount(b, minlength=n_bins + 2)[1:n_bins + 1].to(dt)

    shell_vol = (4.0 / 3.0) * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    n_pairs = n_real * (n_real - 1) / 2.0
    ideal = F * n_pairs * shell_vol / box.prod()
    centers = 0.5 * (edges[1:] + edges[:-1])
    return centers, hist / torch.clamp(ideal, min=1e-30)
