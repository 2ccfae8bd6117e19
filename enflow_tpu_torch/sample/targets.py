"""Boltzmann targets, the port of ``enflow_tpu/sample/targets.py``.

Batched over particles: ``log_prob(x [P, N, 3]) -> [P]``. Ported:
``Target``, ``regularize_energy``, ``lj_cluster``, ``lj_fluid``,
``double_well`` and ``gaussian`` (the force-field target is
``sample/forcefield.py``), each with its atom-sharded
``log_prob_sharded(pos_blk [B, n_blk, 3], mask_blk [B, n_blk], axis) ->
[B]``: a per-shard body on the ring pair reduction
(``parallel/pairwise.py:ring_pair_terms``), its per-molecule sums over atoms
``psum``med over ``axis`` (a collective axis object,
``parallel/collectives.py``), equal to the dense ``log_prob`` to round-off.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..sim.potentials import lj_energy
from ..utils.helpers import min_image


@dataclasses.dataclass(frozen=True)
class Target:
    """A Boltzmann target: batched ``log_prob(x [P, ...]) -> [P]``, and
    ``log_prob_sharded`` for the atom-sharded samplers (None when the target
    has none)."""

    log_prob: Callable
    dim: tuple
    name: str = "target"
    log_prob_sharded: Optional[Callable] = None


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

    def log_prob_sharded(pos_blk, mask_blk, axis):
        """The branches of ``log_prob`` without overrides, atoms sharded:
        the centre of mass and the oscillator ``psum``med, the cap on the
        pair energy alone."""
        from ..parallel.pairwise import ring_pair_terms

        m = mask_blk[..., None]
        zero = torch.zeros((), dtype=pos_blk.dtype, device=pos_blk.device)
        n_real = axis.psum(mask_blk.sum(dim=1)).to(pos_blk.dtype)
        # every shard's oscillator term depends on the centre of mass
        com = axis.pvary(axis.psum(torch.where(m, pos_blk, zero).sum(dim=1))
                         / n_real[:, None])
        one = torch.ones((), dtype=pos_blk.dtype, device=pos_blk.device)
        if default_soft == 0.0:
            def term(d2, valid):
                # lj_energy's semantics: a coincident real pair is inf
                inv2 = torch.where(valid, (sigma * sigma)
                                   / torch.where(valid, d2, one), zero)
                inv6 = inv2 * inv2 * inv2
                e = 4.0 * epsilon * (inv6 * inv6 - inv6)
                return torch.where(valid, e, zero).sum(dim=(1, 2))
        else:
            def term(d2, valid):
                r_sq = torch.where(valid, d2, one) + default_soft
                r6 = r_sq * r_sq * r_sq
                e = 4.0 * epsilon * (1.0 / (r6 * r6) - 1.0 / r6)
                return torch.where(valid, e, zero).sum(dim=(1, 2))
        u = ring_pair_terms(pos_blk, mask_blk, axis, term)
        if default_cap is not None:
            u = regularize_energy(u, default_cap)
        osc = torch.where(m, pos_blk - com[:, None, :], zero)
        u = u + c_osc * axis.psum((osc * osc).sum(dim=(1, 2)))
        return -u / kBT

    return Target(log_prob=log_prob, dim=(n, 3), name=f"lj{n}",
                  log_prob_sharded=log_prob_sharded)


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

    def pair_energy(d2, valid, soft):
        valid = valid & ((d2 > 0.0) | (soft > 0.0))
        if cutoff is not None:
            valid = valid & (d2 < cutoff * cutoff)
        one = torch.ones((), dtype=d2.dtype, device=d2.device)
        r_sq = (torch.where(valid, d2, one) + soft) / s2
        r6 = r_sq * r_sq * r_sq
        e = 4.0 * epsilon * (1.0 / (r6 * r6) - 1.0 / r6)
        return torch.where(valid, e, torch.zeros_like(e)).sum(dim=(-1, -2))

    def log_prob(x: torch.Tensor, softening=None,
                 e_cap=None) -> torch.Tensor:
        soft = default_soft if softening is None else float(softening)
        cap = default_cap if e_cap is None else float(e_cap)
        diff = min_image(x[..., :, None, :] - x[..., None, :, :],
                         torch.as_tensor(box, dtype=x.dtype, device=x.device))
        u = pair_energy((diff * diff).sum(-1), _upper(n, x.device), soft)
        if cap is not None:
            u = regularize_energy(u, cap)
        return -u / kBT

    def log_prob_sharded(pos_blk, mask_blk, axis):
        from ..parallel.pairwise import ring_pair_terms

        u = ring_pair_terms(pos_blk, mask_blk, axis,
                            lambda d2, v: pair_energy(d2, v, default_soft),
                            box=box)
        if default_cap is not None:
            u = regularize_energy(u, default_cap)
        return -u / kBT

    return Target(log_prob=log_prob, dim=(n, 3), name=f"ljfluid{n}",
                  log_prob_sharded=log_prob_sharded)


def double_well(n: int = 4, dim: int = 2, kBT: float = 1.0, a: float = 0.0,
                b: float = -4.0, c: float = 0.9, d0: float = 4.0,
                tau: float = 1.0) -> Target:
    """DW-n pairwise double well over ``[P, n, dim]``: per pair ``u =
    a (d - d0) + b (d - d0)^2 + c (d - d0)^4`` with ``d = sqrt(|dx|^2 +
    1e-12)``."""

    def pair_energy(d2, valid):
        dd = torch.sqrt(d2 + 1e-12) - d0
        u = a * dd + b * dd ** 2 + c * dd ** 4
        return torch.where(valid, u, torch.zeros_like(u)).sum(dim=(-1, -2))

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        diff = x[..., :, None, :] - x[..., None, :, :]
        return -pair_energy((diff * diff).sum(-1),
                            _upper(n, x.device)) / (tau * kBT)

    def log_prob_sharded(pos_blk, mask_blk, axis):
        from ..parallel.pairwise import ring_pair_terms
        return -ring_pair_terms(pos_blk, mask_blk, axis,
                                pair_energy) / (tau * kBT)

    return Target(log_prob=log_prob, dim=(n, dim), name=f"dw{n}",
                  log_prob_sharded=log_prob_sharded)


def gaussian(shape, std: float = 1.0) -> Target:
    """Isotropic Gaussian over ``[P, *shape]`` (an exact-moment oracle)."""
    dims = tuple(range(-len(tuple(shape)), 0))

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return -0.5 * ((x / std) ** 2).sum(dim=dims)

    def log_prob_sharded(pos_blk, mask_blk, axis):
        s = torch.where(mask_blk[..., None], pos_blk / std,
                        torch.zeros((), dtype=pos_blk.dtype,
                                    device=pos_blk.device)) ** 2
        return -0.5 * axis.psum(s.sum(dim=(1, 2)))

    return Target(log_prob=log_prob, dim=tuple(shape), name="gaussian",
                  log_prob_sharded=log_prob_sharded)
