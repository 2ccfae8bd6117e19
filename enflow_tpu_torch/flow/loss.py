"""Alchemical negative log-likelihood against the LJ-fluid Boltzmann base,
the port of ``enflow_tpu/flow/loss.py``::

    H      = sum_mol sum_{i<j} 4*((r^2+s)^-6 - (r^2+s)^-3) + 0.5 * sum(vel^2)
    logZ   = -num_atoms * (log(z_lj) - 1.5*log(2*pi/kBT))      # z_lj = 10
    log_px = -H/kBT + logZ + ldj + log_gaussian(h) + log_gaussian(g)
    loss   = -log_px / num_mols

with the JAX package's parity quirks kept: no periodic wrap in the pair
distances, pairs at distance 0 left out, ``log(2 pi)`` charged once per
``log_gaussian`` call (re-globalized by ``num_log_gaussian_calls``), and
the parity ldj of the flow (``exact_ldj`` off) as the NLL's ldj.

The pair term is the pair-energy kernel's form ``r2``
(``ops/pair_energy.py``): on the card it always launches that kernel,
whatever ``training.loss.pallas_pairwise`` says; on the CPU it runs its
plain version.
"""

import math

import torch

from ..data.system import System
from ..ops.pair_energy import pair_energy
from ..utils.helpers import LOG_2PI, log_gaussian_per_mol


def lj_potential(pos, mask, softening):
    """Batched softened LJ energy ``[B]``: ``sum_{i<j} 4((r^2+s)^-6 -
    (r^2+s)^-3)`` over real, non-coincident pairs."""
    return pair_energy(pos, mask, None, "r2", softening)


def alchemical_log_px(out: System, ldj, kBT, softening,
                      partition_func=10.0):
    """Per-molecule latent log density ``[B]`` under the LJ-fluid base,
    the ``log(2 pi)`` of each Gaussian charged once per molecule."""
    zero = torch.zeros((), dtype=out.pos.dtype, device=out.pos.device)
    kinetic = torch.where(out.mask[..., None], out.vel * out.vel, zero)
    H = lj_potential(out.pos, out.mask, softening)
    H = H + 0.5 * kinetic.sum(dim=(1, 2))
    n_atoms = out.mask.sum(dim=1).to(out.pos.dtype)
    logZ = -n_atoms * (math.log(partition_func)
                       - 1.5 * math.log(2.0 * math.pi / kBT))
    log_gh = log_gaussian_per_mol(out.h, out.mask)
    log_gg = log_gaussian_per_mol(out.g, out.mask)
    return -H / kBT + logZ + ldj + log_gh + log_gg


def alchemical_nll(out: System, ldj, kBT, softening, partition_func=10.0,
                   num_log_gaussian_calls=3):
    """Scalar NLL of a padded batch: the per-molecule terms summed over
    real molecules, the ``log(2 pi)`` per ``log_gaussian`` call
    re-globalized (3 calls for ArgMax, 2 for Floor)."""
    real = out.mask.any(dim=1)
    per_mol = alchemical_log_px(out, ldj, kBT, softening, partition_func)
    num_mols = real.sum().to(out.pos.dtype)
    zero = torch.zeros((), dtype=per_mol.dtype, device=per_mol.device)
    log_px = (torch.where(real, per_mol, zero).sum()
              + 0.5 * num_log_gaussian_calls * LOG_2PI * (num_mols - 1.0))
    return -log_px / num_mols
