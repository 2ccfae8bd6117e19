"""Simulated datasets, the port of ``enflow_tpu/data/simulated.py``: the
frames come from MD run on the dataset's device (FIRE minimization,
Maxwell-Boltzmann thermalization, Langevin-middle dynamics, a frame every
``interval`` steps after ``discard``), with the JAX package's outputs: a
``StateDataReporter``-style CSV ``log`` of every captured frame (step,
potential energy in kJ/mol, temperature in K) and a multi-MODEL PDB
``traj`` of the kept frames, in the same text.

Host draws stay on the dataset's numpy generator, in the JAX package's
order, so one seed gives the same MD seed integer, the same ``g`` (and
latent ``h``) features and the same shuffle order as the JAX package. The
MD seed integer seeds a ``torch.Generator`` on the device, whose draws
differ from ``jax.random``'s: the trajectories agree in distribution, not
bit for bit. The MD runs in float32, the pair-energy kernel's type.

Subclasses implement ``setup(box_red, **params)`` returning
``(energy_grad, pos0, z, name)``: ``energy_grad(pos [N,3]) -> (E,
dE/dpos)`` in reduced units, the initial configuration, atom symbols and a
name.
"""

from __future__ import annotations

import os
from abc import abstractmethod

import numpy as np
import torch

from ..utils import conversion as cv
from ..utils.constants import eps
from .datasets import InMemoryDataset

MD_DTYPE = torch.float32


def _ensure_parent(path):
    """Create a declared output file's parent directory (the example
    configs point log/traj into data/<name>/, which need not exist)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def write_pdb_frames(path, z, frames_ang, box_ang):
    """Minimal multi-MODEL PDB trajectory writer (coordinates in
    Angstrom), the JAX package's text."""
    with open(path, "w") as f:
        f.write(
            "CRYST1{:9.3f}{:9.3f}{:9.3f}  90.00  90.00  90.00 P 1           1\n"
            .format(*[float(b) for b in box_ang]))
        for m, pos in enumerate(frames_ang, start=1):
            f.write(f"MODEL     {m:4d}\n")
            for i, (sym, (x, y, c)) in enumerate(zip(z, pos), start=1):
                el = sym[:2].rjust(2)
                f.write(
                    f"ATOM  {i:5d} {sym:<4.4s} MOL A   1    "
                    f"{x:8.3f}{y:8.3f}{c:8.3f}  1.00  0.00          {el}\n")
            f.write("ENDMDL\n")
        f.write("END\n")


def log_lines(steps, pe, kBT_inst):
    """The CSV log's lines: a header, then step, potential energy (kJ/mol)
    and instantaneous temperature (K) of each captured frame, from float64
    numpy arrays of reduced-unit energies and kBT."""
    lines = ['#"Step","Potential Energy (kJ/mole)","Temperature (K)"']
    for s, e, t in zip(steps, pe, kBT_inst):
        lines.append(f"{int(s)},{e * eps / 1000.0},{cv.lj_to_kelvin(t)}")
    return lines


class SimulatedDataset(InMemoryDataset):
    """In-memory dataset populated by an MD run on ``self.device``."""

    #: True: attach latent features ``h, g ~ N(0, 1/sqrt(kBT))`` instead of
    #: one-hot atom types (when ``node_nf`` is given)
    latent_features = False

    @abstractmethod
    def setup(self, box_red, **params):
        """Return ``(energy_grad, pos0, z, name)``."""

    def process(self, temp, n_iter, interval, dt, friction=1.0, discard=-1,
                dist_unit="ang", time_unit="pico", node_nf=None, log=None,
                traj=None, minimize_steps=200, **setup_params):
        from ..sim.integrate import minimize_fire, simulate, thermalize

        if self.box is None:
            raise ValueError(
                "SimulatedDataset requires a box (lab units) in the dataset "
                "section")
        box_red = cv.dist_to_lj(np.asarray(self.box, np.float64), dist_unit)
        energy_grad, pos0, z, name = self.setup(
            box_red, dist_unit=dist_unit, **setup_params)

        kBT = cv.kelvin_to_lj(float(temp))
        dt_red = cv.time_to_lj_md(float(dt), time_unit)
        friction_red = float(friction) / cv.time_to_lj_md(1.0, time_unit)

        dev = self.device
        box_t = torch.as_tensor(box_red, dtype=MD_DTYPE, device=dev)
        pos0 = torch.as_tensor(np.asarray(pos0), dtype=MD_DTYPE, device=dev)
        n_atoms = int(pos0.shape[0])
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.rng.integers(0, 2**31 - 1)))

        pos_min = minimize_fire(pos0, energy_grad,
                                n_steps=int(minimize_steps), box=box_t)
        vel0 = thermalize(gen, n_atoms, kBT, dtype=MD_DTYPE, device=dev)
        frames = simulate(gen, pos_min, vel0, energy_grad,
                          n_steps=int(n_iter), interval=int(interval),
                          dt=dt_red, friction=friction_red, kBT=kBT,
                          box=box_t)
        host = lambda k: frames[k].detach().cpu().double().numpy()
        steps = frames["step"].numpy()
        pos_frames, vel_frames = host("pos"), host("vel")

        if log:
            lines = log_lines(steps, host("pe"), host("kBT_inst"))
            _ensure_parent(log)
            with open(log, "w") as f:
                f.write("\n".join(lines) + "\n")
            print("\n".join(lines), flush=True)

        report_from = int(discard)
        if report_from == -1:
            report_from = int(interval)
        keep = steps >= report_from

        if traj:
            _ensure_parent(traj)
            write_pdb_frames(
                traj, z, [cv.lj_to_dist(p, "ang") for p in pos_frames[keep]],
                cv.lj_to_dist(box_red, "ang"))

        latent = self.latent_features and node_nf is not None
        for s, pos_r, vel_r in zip(steps[keep], pos_frames[keep],
                                   vel_frames[keep]):
            h = g = None
            if latent:
                std = 1.0 / np.sqrt(kBT)
                h = self.rng.normal(0.0, std, (n_atoms, int(node_nf)))
                g = self.rng.normal(0.0, std, (n_atoms, int(node_nf)))
            self.append(
                z=z,
                pos=cv.lj_to_dist(pos_r, dist_unit),
                vel=cv.lj_to_vel_md(vel_r, dist_unit, time_unit),
                label=f"Simulated dataset: {name} Frame: {int(s)}",
                h=h, g=g)
