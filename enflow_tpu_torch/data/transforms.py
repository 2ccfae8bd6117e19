"""Host-side sample transforms (numpy), a copy of
``enflow_tpu/data/transforms.py``: they run once per frame while a dataset
is built, on ``Sample`` objects (``data/datasets.py``)."""

from __future__ import annotations

import numpy as np

from ..utils.conversion import dist_to_lj, vel_to_lj


class NoneTransform:
    def __call__(self, sample):
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class ConvertPositionsFrom:
    """Positions, box and r_cut from a lab distance unit to reduced units."""

    def __init__(self, input_unit):
        self.input_unit = input_unit

    def __call__(self, sample):
        sample.pos = dist_to_lj(sample.pos, self.input_unit)
        sample.box = dist_to_lj(sample.box, self.input_unit)
        sample.r_cut = dist_to_lj(sample.r_cut, self.input_unit)
        return sample


class ConvertVelocitiesFrom:
    """Velocities from lab units (distance, time) to reduced units."""

    def __init__(self, input_unit1, input_unit2):
        self.input_unit1 = input_unit1
        self.input_unit2 = input_unit2

    def __call__(self, sample):
        sample.vel = vel_to_lj(sample.vel, self.input_unit1, self.input_unit2)
        return sample


class Center:
    """Zero the mean position."""

    def __call__(self, sample):
        sample.pos = sample.pos - sample.pos.mean(axis=0, keepdims=True)
        return sample


class RandomizeVelocity:
    """Maxwell-Boltzmann velocities at ``kBT`` (reduced, mass 1): i.i.d.
    normals of std ``sqrt(kBT)``, drawn from a seeded numpy generator."""

    def __init__(self, kBT, seed=None):
        self.kBT = kBT
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample):
        std = np.sqrt(self.kBT)
        sample.vel = self.rng.normal(0.0, std, size=sample.pos.shape)
        return sample
