"""LJ-fluid simulated dataset, the port of ``enflow_tpu/data/lj.py``: grid
initialization, then the MD of :class:`SimulatedDataset` under the
softened LJ potential ``4((s+r)^-12 - (s+r)^-6)`` with min-image PBC and a
cutoff in units of sigma, which the pair-energy kernel computes (form
``r``)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils import conversion as cv
from .datasets import register_dataset
from .simulated import MD_DTYPE, SimulatedDataset


def arrange_points_on_grid(n, box, gap):
    """Arrange n points on a 3D grid inside ``box`` with edge ``gap``."""
    num_z = int(np.ceil(n ** (1 / 3)))
    num_y = int(np.ceil((n / num_z) ** (1 / 2)))
    num_x = int(np.ceil(n / (num_y * num_z)))
    x = np.linspace(gap, box[0] - gap, num_x)
    y = np.linspace(gap, box[1] - gap, num_y)
    z = np.linspace(gap, box[2] - gap, num_z)
    xv, yv, zv = np.meshgrid(x, y, z)
    points = np.stack((xv.flatten(), yv.flatten(), zv.flatten()), axis=-1)
    return points[:n]


@register_dataset("lj")
class LJDataset(SimulatedDataset):
    """Simulated LJ argon fluid."""

    latent_features = True

    def setup(self, box_red, n_atoms, dist_unit="ang", softening=0.0,
              cutoff=3.0, gap=1.0, **_):
        from ..sim.potentials import softened_lj_energy_grad

        gap_red = cv.dist_to_lj(float(gap), dist_unit)
        cutoff_red = float(cutoff)
        softening = float(softening)
        if self.r_cut is None:
            self.r_cut = cv.lj_to_dist(cutoff_red, dist_unit)
        if "Ar" not in self.atom_types:
            self.atom_types = {"Ar": 0}

        pos0 = arrange_points_on_grid(int(n_atoms), box_red, gap_red)
        box_t = torch.as_tensor(box_red, dtype=MD_DTYPE, device=self.device)
        # every atom real, made once: the MD asks for the force every step
        mask = torch.ones(int(n_atoms), dtype=MD_DTYPE, device=self.device)

        def energy_grad(p):
            return softened_lj_energy_grad(p, box_t, softening, cutoff_red,
                                           mask=mask)

        return energy_grad, pos0, ["Ar"] * int(n_atoms), "LJ"
