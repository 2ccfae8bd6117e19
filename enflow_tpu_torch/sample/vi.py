"""Flow-VI, the port of ``enflow_tpu/sample/vi.py``: train the flow as a
variational family against a Boltzmann target, with no data.

    KL(q || p) = E_{z~base}[ log p0(z) - ldj_R(z) - log p(x) ],  x = R(z)

so the reparameterized loss is ``-(ldj_R + log p(x)).mean()``, with the
gradients flowing through the deterministic reverse flow ``R``
(``flow.reverse_core``). On the card every all-pairs EGCL of the reverse
flow runs the fused kernel, and its backward the variant with parameter
gradients (``ops/egcl_allpairs.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import resolve_device
from ..data.system import System
from ..flow.integrators import FlowConfig, forward_core, reverse_core


def sample_base(gen: torch.Generator, B: int, n_atoms: int, node_nf: int, *,
                box: float, r_cut: float, pos_std: float = 1.0,
                vel_std: float = 1.0, feat_std: float = 1.0,
                dtype=torch.float32, device=None) -> System:
    """A batch of latent Systems from the Gaussian base distribution, drawn
    from ``gen`` (a generator on ``device``, the card unless the caller
    asks for the CPU) in the order h, g, pos, vel."""
    device = resolve_device(device)
    kw = dict(generator=gen, dtype=dtype, device=device)
    shape2, shape3 = (B, n_atoms, node_nf), (B, n_atoms, 3)
    return System(
        h=feat_std * torch.randn(shape2, **kw),
        g=feat_std * torch.randn(shape2, **kw),
        pos=pos_std * torch.randn(shape3, **kw),
        vel=vel_std * torch.randn(shape3, **kw),
        mask=torch.ones((B, n_atoms), dtype=torch.bool, device=device),
        box=torch.full((B, 3), box, dtype=dtype, device=device),
        r_cut=torch.full((B,), r_cut, dtype=dtype, device=device))


def make_base_log_prob(pos_std: float = 1.0, vel_std: float = 1.0,
                       feat_std: float = 1.0) -> Callable:
    """Per-molecule ``[B]`` Gaussian log density matching
    :func:`sample_base`'s draws (normalized, masked)."""

    def log_prob(s: System) -> torch.Tensor:
        am = s.mask[..., None]

        def term(f, std):
            zero = torch.zeros((), dtype=f.dtype, device=f.device)
            n_dims = torch.where(am, torch.ones_like(f), zero).sum(dim=(1, 2))
            sq = torch.where(am, (f / std) ** 2, zero).sum(dim=(1, 2))
            return -0.5 * (sq + n_dims * math.log(2.0 * math.pi * std * std))

        return (term(s.h, feat_std) + term(s.g, feat_std)
                + term(s.pos, pos_std) + term(s.vel, vel_std))

    return log_prob


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach()


def flow_vi_loss(params, cfg: FlowConfig, base_batch: System,
                 target_log_prob: Callable, *, stl: bool = False,
                 base_log_prob: Callable | None = None):
    """Reverse-KL loss ``-(ldj_R + log p(R(z))).mean()`` and the pushed
    batch ``R(z)``.

    The ldj is the true log-det (``exact_ldj`` forced on), as the KL
    identity needs. ``stl=True`` is the sticking-the-landing estimator:
    ``log q`` re-encodes ``x`` through the forward flow with detached
    parameters (gradients still flow through ``x``), which removes the
    score term from the gradient; its value is the default's plus
    ``E[log p0(z)]``. ``base_log_prob`` (default: unit-std
    :func:`make_base_log_prob`) must match the base batch's distribution.
    """
    cfg = dataclasses.replace(cfg, exact_ldj=True)
    out, ldj = reverse_core(params, cfg, base_batch)
    if not stl:
        return -(ldj + target_log_prob(out)).mean(), out
    z_re, ldj_fwd = forward_core(_detached(params), cfg, out)
    log_q = (base_log_prob or make_base_log_prob())(z_re) + ldj_fwd
    return (log_q - target_log_prob(out)).mean(), out


def make_system_target(log_prob_pos: Callable,
                       kBT_aux: float = 1.0) -> Callable:
    """Lift a batched positions-only target (``log_prob(pos [B, N, 3]) ->
    [B]``, e.g. ``targets.lj_cluster(...).log_prob``) to a System target:
    Boltzmann on positions, unit Gaussians (scaled by ``kBT_aux``) on
    velocities and features."""

    def log_prob(sys_b: System) -> torch.Tensor:
        am = sys_b.mask[..., None]
        aux = 0.0
        for f in (sys_b.vel, sys_b.h, sys_b.g):
            aux = aux + torch.where(am, f * f, torch.zeros((), dtype=f.dtype,
                                                           device=f.device)
                                    ).sum(dim=(1, 2))
        return log_prob_pos(sys_b.pos) - 0.5 * aux / kBT_aux

    return log_prob
