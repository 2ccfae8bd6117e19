"""Boltzmann targets, the port of ``enflow_tpu/sample/targets.py``.

Batched over particles: ``log_prob(x [P, N, 3]) -> [P]``. Ported:
``Target``, ``regularize_energy``, ``lj_cluster``, ``lj_fluid``,
``double_well`` and ``gaussian`` (the force-field target is
``sample/forcefield.py``); the atom-sharded ``log_prob_sharded`` members
are ROADMAP A7.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..sim.potentials import lj_energy
from ..utils.helpers import min_image


@dataclasses.dataclass(frozen=True)
class Target:
    """A Boltzmann target: batched ``log_prob(x [P, ...]) -> [P]``."""

    log_prob: Callable
    dim: tuple
    name: str = "target"


def regularize_energy(u: torch.Tensor, e_high: float) -> torch.Tensor:
    """Log-cap high energies: linear below ``e_high``, logarithmic above
    (the untaken branch is clamped so its gradient stays finite)."""
    return torch.where(u > e_high,
                       e_high + torch.log1p(torch.clamp(u - e_high, min=0.0)),
                       u)


def lj_cluster(n: int, kBT: float = 1.0, epsilon: float = 1.0,
               sigma: float = 1.0, c_osc: float = 0.5,
               softening: float = 0.0, e_cap: float | None = None) -> Target:
    """LJ_n cluster: ``U = LJ + c_osc * sum |x - com|^2`` over ``[P, n, 3]``.

    ``softening`` uses the soft-core ``r^2 + s`` form; ``e_cap`` caps the
    PAIR energy only (the harmonic confinement stays exact; see the JAX
    package's ``lj_cluster`` for why).

    ``log_prob(x, softening=..., e_cap=...)`` takes overrides for an
    annealing schedule, as the JAX package's traced scalars: under an
    override the softened branch always runs, also at softening 0. That
    branch drops bitwise-coincident pairs when the softening is 0, where
    ``r_sq = 0`` would give ``inf - inf``. Without overrides a softening of
    0 takes the plain ``lj_energy``."""
    default_soft, default_cap = softening, e_cap

    def log_prob(x: torch.Tensor, softening=None,
                 e_cap=None) -> torch.Tensor:
        override = softening is not None or e_cap is not None
        soft = default_soft if softening is None else float(softening)
        cap = default_cap if e_cap is None else float(e_cap)
        com = x.mean(dim=-2, keepdim=True)
        if not override and soft == 0.0:
            u = lj_energy(x, epsilon=epsilon, sigma=sigma)
        else:
            diff = x[..., :, None, :] - x[..., None, :, :]
            d2 = (diff * diff).sum(-1)
            valid = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                          device=x.device), diagonal=1)
            valid = valid & ((d2 > 0.0) | (soft > 0.0))
            one = torch.ones((), dtype=x.dtype, device=x.device)
            r_sq = torch.where(valid, d2, one) + soft
            r6 = r_sq * r_sq * r_sq
            e = 4.0 * epsilon * (1.0 / (r6 * r6) - 1.0 / r6)
            u = torch.where(valid, e, torch.zeros_like(e)).sum(dim=(-1, -2))
        if cap is not None:
            u = regularize_energy(u, cap)
        u = u + c_osc * ((x - com) ** 2).sum(dim=(-1, -2))
        return -u / kBT

    return Target(log_prob=log_prob, dim=(n, 3), name=f"lj{n}")


def _upper(n: int, device):
    return torch.triu(torch.ones((n, n), dtype=torch.bool, device=device),
                      diagonal=1)


def lj_fluid(n: int, box: float, kBT: float = 1.0, epsilon: float = 1.0,
             sigma: float = 1.0, softening: float = 0.0,
             cutoff: float | None = None,
             e_cap: float | None = None) -> Target:
    """Periodic LJ fluid over ``[P, n, 3]``: ``U = sum_{i<j} 4 eps (a^6 -
    a^3)`` with ``a = s^2 / (|dx|_mi^2 + softening)`` on min-image
    displacements (``round`` half to even, as ``jnp.round``), pairs at or
    beyond ``cutoff`` dropped, ``e_cap`` capping the pair energy. No
    centre-of-mass restraint: the box confines. ``log_prob(x, softening=...,
    e_cap=...)`` takes the anneal's overrides, as :func:`lj_cluster`. A
    coincident pair keeps its softened repulsion when the softening is > 0
    and is dropped at 0."""
    s2 = sigma * sigma
    default_soft, default_cap = softening, e_cap

    def log_prob(x: torch.Tensor, softening=None,
                 e_cap=None) -> torch.Tensor:
        soft = default_soft if softening is None else float(softening)
        cap = default_cap if e_cap is None else float(e_cap)
        diff = min_image(x[..., :, None, :] - x[..., None, :, :],
                         torch.as_tensor(box, dtype=x.dtype, device=x.device))
        d2 = (diff * diff).sum(-1)
        valid = _upper(n, x.device) & ((d2 > 0.0) | (soft > 0.0))
        if cutoff is not None:
            valid = valid & (d2 < cutoff * cutoff)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        r_sq = (torch.where(valid, d2, one) + soft) / s2
        r6 = r_sq * r_sq * r_sq
        e = 4.0 * epsilon * (1.0 / (r6 * r6) - 1.0 / r6)
        u = torch.where(valid, e, torch.zeros_like(e)).sum(dim=(-1, -2))
        if cap is not None:
            u = regularize_energy(u, cap)
        return -u / kBT

    return Target(log_prob=log_prob, dim=(n, 3), name=f"ljfluid{n}")


def double_well(n: int = 4, dim: int = 2, kBT: float = 1.0, a: float = 0.0,
                b: float = -4.0, c: float = 0.9, d0: float = 4.0,
                tau: float = 1.0) -> Target:
    """DW-n pairwise double well over ``[P, n, dim]``: per pair ``u =
    a (d - d0) + b (d - d0)^2 + c (d - d0)^4`` with ``d = sqrt(|dx|^2 +
    1e-12)``."""

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        diff = x[..., :, None, :] - x[..., None, :, :]
        d = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        dd = d - d0
        u = a * dd + b * dd ** 2 + c * dd ** 4
        u = torch.where(_upper(n, x.device), u, torch.zeros_like(u))
        return -u.sum(dim=(-1, -2)) / (tau * kBT)

    return Target(log_prob=log_prob, dim=(n, dim), name=f"dw{n}")


def gaussian(shape, std: float = 1.0) -> Target:
    """Isotropic Gaussian over ``[P, *shape]`` (an exact-moment oracle)."""
    dims = tuple(range(-len(tuple(shape)), 0))

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return -0.5 * ((x / std) ** 2).sum(dim=dims)

    return Target(log_prob=log_prob, dim=tuple(shape), name="gaussian")
