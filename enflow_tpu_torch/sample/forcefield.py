"""Molecular force-field Boltzmann targets, the port of
``enflow_tpu/sample/forcefield.py``:

    E = sum_bonds    k_b (r - r0)^2
      + sum_angles   k_a (theta - theta0)^2
      + sum_torsions k_t (1 + cos(n*phi - phase))
      + sum_pairs    lj_scale * 4 eps_ij ((s_ij/r)^12 - (s_ij/r)^6)
                   + q_scale * ke q_i q_j / r

with Lorentz-Berthelot combining and pair scales from the bond graph (1-2
and 1-3 excluded, 1-4 scaled). The energy is batched over leading axes,
``pos [..., N, 3] -> [...]``, with index gathers where the JAX package
vmaps a per-configuration function; every term is plain PyTorch (the JAX
package's force field reaches no Pallas kernel either). The parameter
dict's bond-graph walk, ``zmatrix_to_cartesian`` and
``free_energy_profile`` are numpy, copied from the JAX module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from .targets import Target, regularize_energy


@dataclasses.dataclass(frozen=True)
class ForceField:
    """Force-field parameters as tensors on one device (indices int64)."""

    bond_idx: torch.Tensor      # [NB, 2]
    bond_k: torch.Tensor        # [NB]
    bond_r0: torch.Tensor       # [NB]
    angle_idx: torch.Tensor     # [NA, 3]
    angle_k: torch.Tensor       # [NA]
    angle_t0: torch.Tensor      # [NA]
    torsion_idx: torch.Tensor   # [NT, 4]
    torsion_k: torch.Tensor     # [NT]
    torsion_n: torch.Tensor     # [NT]
    torsion_phase: torch.Tensor  # [NT]
    sigma: torch.Tensor         # [N]
    epsilon: torch.Tensor       # [N]
    charge: torch.Tensor        # [N]
    lj_scale: torch.Tensor      # [N, N] (0 excluded, lj_14 for 1-4, 1 else)
    q_scale: torch.Tensor       # [N, N]
    ke: float = 1.0             # Coulomb constant in the working units

    @property
    def n_atoms(self) -> int:
        return self.sigma.shape[0]

    @staticmethod
    def from_dict(d, dtype=torch.float64, device=None, lj_14: float = 0.5,
                  q_14: float = 1.0 / 1.2, ke: float = 1.0) -> "ForceField":
        """Build from a plain dict (parsed YAML/JSON) with keys ``bonds:
        [[i, j, k, r0], ...]``, ``angles: [[i, j, k, ktheta, theta0],
        ...]``, ``torsions: [[i, j, k, l, kphi, n, phase], ...]`` and
        ``atoms: [[sigma, epsilon, charge], ...]``, in ``dtype`` on
        ``device`` (the card unless the caller asks for the CPU). The pair
        scales come from the bond graph (AMBER 1-4 factors by default)."""
        device = resolve_device(device)
        bonds = np.asarray(d.get("bonds", np.zeros((0, 4))), np.float64)
        angles = np.asarray(d.get("angles", np.zeros((0, 5))), np.float64)
        torsions = np.asarray(d.get("torsions", np.zeros((0, 7))), np.float64)
        atoms = np.asarray(d["atoms"], np.float64)
        n = atoms.shape[0]

        # bond graph -> 1-2/1-3/1-4 classification
        adj = [[] for _ in range(n)]
        for b in bonds[:, :2].astype(int):
            adj[b[0]].append(b[1])
            adj[b[1]].append(b[0])
        lj_s = np.ones((n, n))
        q_s = np.ones((n, n))
        np.fill_diagonal(lj_s, 0.0)
        np.fill_diagonal(q_s, 0.0)
        for i in range(n):
            for j in adj[i]:                       # 1-2
                lj_s[i, j] = q_s[i, j] = 0.0
                for k in adj[j]:                   # 1-3
                    if k != i:
                        lj_s[i, k] = q_s[i, k] = 0.0
        for i in range(n):
            for j in adj[i]:
                for k in adj[j]:
                    if k == i:
                        continue
                    for l in adj[k]:               # 1-4 (unless closer)
                        if l in (i, j):
                            continue
                        if lj_s[i, l] == 1.0:
                            lj_s[i, l] = lj_14
                            q_s[i, l] = q_14

        def arr(x, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=device)

        return ForceField(
            bond_idx=arr(bonds[:, :2], torch.int64),
            bond_k=arr(bonds[:, 2]), bond_r0=arr(bonds[:, 3]),
            angle_idx=arr(angles[:, :3], torch.int64),
            angle_k=arr(angles[:, 3]), angle_t0=arr(angles[:, 4]),
            torsion_idx=arr(torsions[:, :4], torch.int64),
            torsion_k=arr(torsions[:, 4]), torsion_n=arr(torsions[:, 5]),
            torsion_phase=arr(torsions[:, 6]),
            sigma=arr(atoms[:, 0]), epsilon=arr(atoms[:, 1]),
            charge=arr(atoms[:, 2]),
            lj_scale=arr(lj_s), q_scale=arr(q_s), ke=float(ke))


def _dot(u, v):
    return (u * v).sum(-1)


def _angle(a, b, c):
    """Angle at b for points a-b-c (last axis xyz), as ``atan2(|u x v|,
    u . v)``."""
    u = a - b
    v = c - b
    cross = torch.linalg.cross(u, v, dim=-1)
    return torch.atan2(torch.linalg.vector_norm(cross, dim=-1), _dot(u, v))


def _dihedral(a, b, c, d):
    """Torsion angle of a-b-c-d (IUPAC sign convention)."""
    b1 = b - a
    b2 = c - b
    b3 = d - c
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    m1 = torch.linalg.cross(
        n1, b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True), dim=-1)
    return torch.atan2(_dot(m1, n2), _dot(n1, n2))


def _at(pos, idx, col):
    return pos[..., idx[:, col], :]


def ff_energy(ff: ForceField, pos: torch.Tensor) -> torch.Tensor:
    """Total force-field energy, ``pos [..., N, 3] -> [...]``."""
    e = torch.zeros(pos.shape[:-2], dtype=pos.dtype, device=pos.device)

    if ff.bond_idx.shape[0]:
        d = _at(pos, ff.bond_idx, 0) - _at(pos, ff.bond_idx, 1) + 1e-30
        r = torch.linalg.vector_norm(d, dim=-1)
        e = e + (ff.bond_k * (r - ff.bond_r0) ** 2).sum(-1)

    if ff.angle_idx.shape[0]:
        th = _angle(*(_at(pos, ff.angle_idx, c) for c in range(3)))
        e = e + (ff.angle_k * (th - ff.angle_t0) ** 2).sum(-1)

    if ff.torsion_idx.shape[0]:
        phi = _dihedral(*(_at(pos, ff.torsion_idx, c) for c in range(4)))
        e = e + (ff.torsion_k * (1.0 + torch.cos(ff.torsion_n * phi
                                                 - ff.torsion_phase))
                 ).sum(-1)

    # nonbonded: LJ (Lorentz-Berthelot) + Coulomb with pair scales; r is
    # sqrt(1) off the upper triangle BEFORE the divisions, so the masked
    # entries' gradients stay finite
    n = ff.n_atoms
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    iu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=pos.device),
                    diagonal=1)
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    r = torch.sqrt(torch.where(iu, d2, one))
    sig = 0.5 * (ff.sigma[:, None] + ff.sigma[None, :])
    eps = torch.sqrt(ff.epsilon[:, None] * ff.epsilon[None, :])
    s6 = (sig / r) ** 6
    e_lj = ff.lj_scale * 4.0 * eps * (s6 * s6 - s6)
    e_q = ff.q_scale * ff.ke * ff.charge[:, None] * ff.charge[None, :] / r
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return e + torch.where(iu, e_lj + e_q, zero).sum(dim=(-1, -2))


def forcefield_target(ff: ForceField, kBT: float = 1.0,
                      e_cap: float | None = None) -> Target:
    """Boltzmann target ``log p(x) = -E_ff(x) / kBT`` over ``[P, N, 3]``,
    on the force field's device. ``e_cap`` log-caps extreme energies
    (``targets.regularize_energy``); ``log_prob(x, e_cap=...)`` overrides
    it (``None`` there: no cap), as the JAX package's keyword does."""

    def log_prob(x, e_cap=e_cap):
        u = ff_energy(ff, x)
        if e_cap is not None:
            u = regularize_energy(u, e_cap)
        return -u / kBT

    return Target(log_prob=log_prob, dim=(ff.n_atoms, 3), name="forcefield")


def dihedral_angles(ff: ForceField, pos: torch.Tensor) -> torch.Tensor:
    """Torsion angles ``[..., NT]`` of configurations ``pos [..., N, 3]``
    (free-energy observables, e.g. alanine dipeptide's phi/psi)."""
    return _dihedral(*(_at(pos, ff.torsion_idx, c) for c in range(4)))


def zmatrix_to_cartesian(entries) -> np.ndarray:
    """Cartesian coordinates from internal coordinates (NeRF), numpy.

    ``entries`` is a list of ``[i, j, k, l, r, theta, phi]`` rows placing
    atom ``i`` at distance ``r`` from ``j``, bond angle ``theta`` (radians)
    with ``k``, and dihedral ``phi`` about ``j-k`` relative to ``l``. The
    first three rows may use ``-1`` for missing references (first atom at
    the origin, second along +x, third in the xy-plane); rows reference
    only atoms already placed (``example/ala2_ff.yaml``'s ``zmatrix``)."""
    n = max(int(e[0]) for e in entries) + 1
    pos = np.zeros((n, 3))
    for e in entries:
        i, j, k, l = (int(v) for v in e[:4])
        r, theta, phi = (float(v) for v in e[4:7])
        if j < 0:                                     # first atom: origin
            pos[i] = 0.0
        elif k < 0:                                   # second: along +x
            pos[i] = pos[j] + [r, 0.0, 0.0]
        else:
            # NeRF: bond i-j, angle i-j-k, dihedral i-j-k-l
            ab = pos[k] - (pos[l] if l >= 0
                           else pos[k] + np.array([0.0, 0.0, 1.0]))
            bc = pos[j] - pos[k]
            bc_u = bc / np.linalg.norm(bc)
            n1 = np.cross(ab, bc)
            if np.linalg.norm(n1) < 1e-10:            # colinear reference
                n1 = np.cross(bc_u, [0.0, 0.0, 1.0])
                if np.linalg.norm(n1) < 1e-10:
                    n1 = np.cross(bc_u, [0.0, 1.0, 0.0])
            n1 = n1 / np.linalg.norm(n1)
            m1 = np.cross(n1, bc_u)
            # the n1 term's sign makes the requested phi equal the measured
            # _dihedral(i, j, k, l) (IUPAC convention)
            d2 = np.array([-r * np.cos(theta),
                           r * np.sin(theta) * np.cos(phi),
                           -r * np.sin(theta) * np.sin(phi)])
            pos[i] = pos[j] + d2[0] * bc_u + d2[1] * m1 + d2[2] * n1
    return pos


def free_energy_profile(angles, kBT: float, bins: int = 36, weights=None):
    """1-D dihedral free-energy profile ``F = -kBT log p`` over [-pi, pi]
    (numpy): ``angles [S]``, optional importance ``weights [S]``; returns
    ``(centers [bins], F [bins])`` with F shifted to min 0 and empty bins
    +inf."""
    angles = np.asarray(angles)
    hist, edges = np.histogram(angles, bins=bins, range=(-np.pi, np.pi),
                               weights=None if weights is None
                               else np.asarray(weights), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    with np.errstate(divide="ignore"):
        F = -float(kBT) * np.log(hist)
    return centers, F - F[np.isfinite(F)].min()
