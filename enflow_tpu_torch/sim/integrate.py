"""MD in PyTorch: Langevin-middle (BAOAB) integrator, FIRE minimizer and
Maxwell-Boltzmann thermalization, the port of
``enflow_tpu/sim/integrate.py``.

Everything runs in LJ reduced units (mass 1) on the tensors' device. A
force field here is ``energy_grad(pos) -> (E, dE/dpos)``: the pair-energy
kernel gives both from one pass, so no step takes a second autograd pass.
Python loops take the place of ``lax.scan``; FIRE's branches are
``torch.where`` on device scalars, so no step waits on the host.

The Langevin-middle step (kick, half-drift, O-step, half-drift)::

    v <- v - dt * dE/dx / m
    x <- x + dt/2 * v
    v <- a*v + sqrt(kBT/m)*sqrt(1-a^2) * R,   a = exp(-gamma*dt)
    x <- x + dt/2 * v
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..utils.helpers import apply_pbc


def instantaneous_temperature(vel, mass=1.0):
    """kBT estimate from kinetic energy: ``sum(m v^2) / (3 N)``."""
    return (mass * (vel * vel)).sum() / (3.0 * vel.shape[0])


def thermalize(gen: torch.Generator, n_atoms, kBT, mass=1.0,
               dtype=torch.float32, device=None):
    """Maxwell-Boltzmann velocities ``[n_atoms, 3]``."""
    std = math.sqrt(kBT / mass)
    return std * torch.randn((n_atoms, 3), generator=gen, dtype=dtype,
                             device=device)


def langevin_middle_step(pos, vel, energy_grad: Callable, dt, friction, kBT,
                         noise, mass=1.0, box=None):
    """One BAOAB step with the given standard-normal ``noise [N,3]``;
    returns ``(pos, vel)``. With a ``box``, positions stay wrapped."""
    _, g = energy_grad(pos)
    vel = vel - dt * g / mass
    pos = pos + 0.5 * dt * vel
    a = math.exp(-friction * dt)
    vel = a * vel + math.sqrt(kBT / mass) * math.sqrt(1.0 - a * a) * noise
    pos = pos + 0.5 * dt * vel
    if box is not None:
        pos = apply_pbc(pos, box)
    return pos, vel


def simulate(gen: torch.Generator, pos0, vel0, energy_grad: Callable, *,
             n_steps: int, interval: int, dt, friction, kBT, box=None,
             mass=1.0):
    """Langevin MD capturing a frame every ``interval`` steps (steps
    ``interval, 2*interval, ... <= n_steps``); with a ``box`` the
    positions are kept wrapped, as ``integrate.py:71-107`` does. Returns
    a dict of stacked device tensors ``pos [F,N,3]``, ``vel``, ``pe [F]``,
    ``kBT_inst [F]`` and ``step [F]``."""
    pos, vel = pos0, vel0
    frames = {"pos": [], "vel": [], "pe": [], "kBT_inst": []}
    n_frames = n_steps // interval
    for _ in range(n_frames):
        for _ in range(interval):
            noise = torch.randn(vel.shape, generator=gen, dtype=vel.dtype,
                                device=vel.device)
            pos, vel = langevin_middle_step(pos, vel, energy_grad, dt,
                                            friction, kBT, noise, mass, box)
        e, _ = energy_grad(pos)
        frames["pos"].append(apply_pbc(pos, box) if box is not None else pos)
        frames["vel"].append(vel)
        frames["pe"].append(e)
        frames["kBT_inst"].append(instantaneous_temperature(vel, mass))
    out = {k: torch.stack(v) for k, v in frames.items()}
    out["step"] = torch.arange(1, n_frames + 1) * interval
    return out


def minimize_fire(pos0, energy_grad: Callable, *, n_steps: int = 200,
                  dt_start: float = 0.01, dt_max: float = 0.1,
                  alpha_start: float = 0.1, f_inc: float = 1.1,
                  f_dec: float = 0.5, f_alpha: float = 0.99, n_min: int = 5,
                  max_step: float = 0.05, box=None):
    """FIRE energy minimization with a fixed step count and a per-coordinate
    step cap (``integrate.py:167-207``); ``box`` keeps positions wrapped."""
    dev, dtype = pos0.device, pos0.dtype
    pos, vel = pos0, torch.zeros_like(pos0)
    dt = torch.tensor(dt_start, dtype=dtype, device=dev)
    alpha = torch.tensor(alpha_start, dtype=dtype, device=dev)
    n_pos = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(n_steps):
        _, g = energy_grad(pos)
        f = -g
        vel = vel + dt * f
        power = (f * vel).sum()
        f_norm = torch.sqrt((f * f).sum()) + 1e-12
        v_norm = torch.sqrt((vel * vel).sum())
        vel_mixed = (1.0 - alpha) * vel + alpha * f / f_norm * v_norm
        uphill = power <= 0.0
        vel = torch.where(uphill, zero, vel_mixed)
        n_pos = torch.where(uphill, 0, n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                         torch.where(uphill, dt * f_dec, dt))
        alpha = torch.where(grow, alpha * f_alpha,
                            torch.where(uphill, alpha_start, alpha))
        pos = pos + torch.clamp(dt * vel, -max_step, max_step)
        if box is not None:
            pos = apply_pbc(pos, box)
    return pos
