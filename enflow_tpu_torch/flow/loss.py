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
plain version. Atom-sharded (``axis_name``, a collective axis object of
``parallel/collectives.py``), the pair term is the ring term
(``parallel/pairwise.py:ring_alchemical_lj``, plain PyTorch as in the JAX
package) and every per-molecule sum over atoms a ``psum``.
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
                      partition_func=10.0, axis_name=None):
    """Per-molecule latent log density ``[B]`` under the LJ-fluid base,
    the ``log(2 pi)`` of each Gaussian charged once per molecule."""
    zero = torch.zeros((), dtype=out.pos.dtype, device=out.pos.device)
    am = out.mask[..., None]
    kinetic = torch.where(am, out.vel * out.vel, zero)
    ax = axis_name
    if ax is None:
        H = lj_potential(out.pos, out.mask, softening)
        H = H + 0.5 * kinetic.sum(dim=(1, 2))
        n_atoms = out.mask.sum(dim=1)
        log_gh = log_gaussian_per_mol(out.h, out.mask)
        log_gg = log_gaussian_per_mol(out.g, out.mask)
    else:
        from ..parallel.pairwise import ring_alchemical_lj

        def asum(x):
            return ax.psum(torch.where(am, x, zero).sum(dim=(1, 2)))

        H = ring_alchemical_lj(out.pos, out.mask, softening, ax)
        H = H + 0.5 * asum(out.vel * out.vel)
        n_atoms = ax.psum(out.mask.sum(dim=1))
        log_gh = -0.5 * (asum(out.h * out.h) + LOG_2PI)
        log_gg = -0.5 * (asum(out.g * out.g) + LOG_2PI)
    n_atoms = n_atoms.to(out.pos.dtype)
    logZ = -n_atoms * (math.log(partition_func)
                       - 1.5 * math.log(2.0 * math.pi / kBT))
    return -H / kBT + logZ + ldj + log_gh + log_gg


def alchemical_nll(out: System, ldj, kBT, softening, partition_func=10.0,
                   num_log_gaussian_calls=3, axis_name=None, data_axis=None):
    """Scalar NLL of a padded batch: the per-molecule terms summed over
    real molecules, the ``log(2 pi)`` per ``log_gaussian`` call
    re-globalized (3 calls for ArgMax, 2 for Floor). ``axis_name``: the
    atoms' axis when sharded; ``data_axis``: the axis whose shards hold the
    other molecules of the batch (the sums over molecules are ``psum``med
    over it, so every rank holds the global loss)."""
    real = out.mask.any(dim=1)
    per_mol = alchemical_log_px(out, ldj, kBT, softening, partition_func,
                                axis_name=axis_name)
    if axis_name is not None:
        # replicated over the shards: one copy before summing molecules
        real = axis_name.collapse(axis_name.psum(real.to(torch.int32)) > 0)
        per_mol = axis_name.collapse(per_mol)
    zero = torch.zeros((), dtype=per_mol.dtype, device=per_mol.device)
    tot = torch.where(real, per_mol, zero).sum()
    num_mols = real.sum().to(out.pos.dtype)
    if data_axis is not None:
        tot, num_mols = data_axis.psum(tot), data_axis.psum(num_mols)
    log_px = tot + 0.5 * num_log_gaussian_calls * LOG_2PI * (num_mols - 1.0)
    return -log_px / num_mols
