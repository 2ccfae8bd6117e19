"""Invertible leapfrog flow, the port of ``enflow_tpu/flow/integrators.py``.

A Python loop over the per-step EGCL parameters (stacked on a leading
``[n_iter]`` axis, as in the JAX package) takes the place of ``lax.scan``.
LF forward step::

    (Q, F, G) = EGCL_k(h, pos)
    vel  = exp(Q) * vel + F * dt
    g    = g + G * dt
    pos  = pos + vel * dt ;  pbc wrap
    h    = h + g * dt
    ldj += ldj_factor * Q.sum()

and its exact inverse. Ported: ``FlowConfig``, ``init_flow``, ``_egcl_at``,
the LF ``forward_core``/``reverse_core`` with ``position_update='shift'``,
parity and exact ldj, the ArgMax-dequantizing ``forward``/``reverse``, in
the ``all_pairs`` and ``images`` neighbor modes, with ``track_overflow``
(the slots an ``images`` build dropped, summed over steps). The VV
integrator, the learned drifts, the Floor dequantizer, atom sharding and
the other neighbor modes raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..data.neighbors import neighbors_with_diffs
from ..data.system import System
from ..nn import argmax as argmax_deq
from ..nn.egcl import (EGCLConfig, init_egcl, apply_egcl,
                       apply_egcl_fused_allpairs, plain_route)


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Flow hyperparameters: the fields and defaults of the JAX package's
    ``FlowConfig`` (see its docstrings for their meaning)."""

    n_iter: int
    dt: float
    egcl: EGCLConfig
    integrator: str = "lf"
    dequantizer: str = "argmax"
    nbr_capacity: Optional[int] = None
    nbr_mode: str = "dense"
    cells_per_dim: Optional[int] = None
    cell_capacity: Optional[int] = None
    exact_ldj: bool = False
    dequant_scale: float = 1.0
    # Accepted and without effect: both EGCL kernels' autograd Functions
    # (all-pairs and gathered-edge) save only their inputs and recompute
    # the [.., K, H] edge tensors inside their backward kernels, which is
    # what remat buys in JAX. The plain CPU path keeps autograd's default
    # residuals.
    remat: bool = True
    remat_policy: Optional[str] = None
    scan_unroll: int = 1
    axis_name: Optional[str] = None
    position_update: str = "shift"
    pos_scale_max: float = 3.0
    track_overflow: bool = False

    @property
    def num_networks(self) -> int:
        return self.n_iter + 1 if self.integrator == "vv" else self.n_iter

    @property
    def ldj_factor(self) -> float:
        return 3.0 if self.exact_ldj else 1.0


def _check_supported(cfg: FlowConfig):
    if cfg.integrator != "lf":
        raise NotImplementedError(
            f"integrator={cfg.integrator!r} is not ported yet (ROADMAP queue "
            "A item 3, VV integrator); the port runs integrator 'lf'")
    if cfg.position_update != "shift":
        raise NotImplementedError(
            f"position_update={cfg.position_update!r} is not ported yet "
            "(ROADMAP queue A item 3, drift and coupled modes)")
    if cfg.axis_name:
        raise NotImplementedError(
            "atom-sharded flows are not ported yet (ROADMAP queue A item 9)")
    if cfg.nbr_mode not in ("all_pairs", "images"):
        raise NotImplementedError(
            f"nbr_mode={cfg.nbr_mode!r} is not ported yet (ROADMAP queue A "
            "items 2 and 7); the port runs nbr_mode 'all_pairs' and "
            "'images'")
    if cfg.egcl.use_pallas in ("v2", "v3") and cfg.nbr_mode != "all_pairs":
        raise ValueError(f"use_pallas={cfg.egcl.use_pallas!r} requires "
                         "nbr_mode='all_pairs'")


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _index(tree, k: int):
    if isinstance(tree, dict):
        return {key: _index(v, k) for key, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, k) for v in tree]
    return tree[k]


def init_flow(gen: torch.Generator, cfg: FlowConfig, dtype=torch.float32,
              device=None):
    """Flow params: stacked per-step EGCLs + dequantizer parameters, on
    ``device`` (``cuda`` unless the caller asks for another)."""
    device = resolve_device(device)
    if cfg.integrator not in ("lf", "vv"):
        raise ValueError(cfg.integrator)
    if cfg.position_update != "shift":
        raise NotImplementedError(
            f"position_update={cfg.position_update!r} is not ported yet "
            "(ROADMAP queue A item 3, drift and coupled modes)")
    networks = _stack([init_egcl(gen, cfg.egcl, dtype, device)
                       for _ in range(cfg.num_networks)])
    if cfg.dequantizer == "argmax":
        dequant = argmax_deq.init_argmax(gen, cfg.egcl.node_nf,
                                         cfg.egcl.hidden_nf, dtype, device)
    elif cfg.dequantizer == "floor":
        dequant = {}
    else:
        raise ValueError(cfg.dequantizer)
    return {"networks": networks, "dequant": dequant}


def _egcl_at(params, cfg: FlowConfig, net_params, sys: System):
    """One EGCL on the current state; returns ``((Q, F, G), overflow)``.

    ``all_pairs``: on the card the fused all-pairs kernel, except for the
    EGCLs that ``plain_route`` sends to the plain EGCL; on the CPU
    ``use_pallas: v2|v3`` selects the kernel's plain version and every other
    value the plain EGCL (the same function, as in the JAX package).
    ``images``: the multi-image neighbor list is rebuilt from the current
    positions and the EGCL runs on the gathered rows (the gathered-edge
    kernel on the card); ``overflow`` counts the slots the build dropped
    (a device scalar, 0 in ``all_pairs`` mode)."""
    if cfg.nbr_mode == "all_pairs":
        zero = torch.zeros((), dtype=torch.int32, device=sys.pos.device)
        if (sys.pos.is_cuda and not plain_route(cfg.egcl)) or \
                cfg.egcl.use_pallas in ("v2", "v3"):
            return apply_egcl_fused_allpairs(net_params, cfg.egcl, sys.h,
                                             sys.pos, sys.box, sys.mask), zero
        nbrs, cd = neighbors_with_diffs(sys.pos, sys.box, sys.mask,
                                        sys.r_cut, cfg.nbr_capacity,
                                        cfg.nbr_mode)
        return apply_egcl(net_params, cfg.egcl, sys.h, cd, nbrs.idx,
                          nbrs.mask, sys.mask, all_pairs=True), zero
    nbrs, cd, ovf = neighbors_with_diffs(sys.pos, sys.box, sys.mask,
                                         sys.r_cut, cfg.nbr_capacity,
                                         cfg.nbr_mode, with_overflow=True)
    return apply_egcl(net_params, cfg.egcl, sys.h, cd, nbrs.idx, nbrs.mask,
                      sys.mask), ovf


def _ldj_sum(cfg: FlowConfig, Q):
    return cfg.ldj_factor * Q.sum(dim=(1, 2))


def _lf_forward(params, cfg: FlowConfig, sys: System):
    dt = cfg.dt
    ldj_steps, ovf = [], 0
    for k in range(cfg.n_iter):
        (Q, F, G), o = _egcl_at(params, cfg, _index(params["networks"], k),
                                sys)
        vel = torch.exp(Q) * sys.vel + F * dt
        g = sys.g + G * dt
        ldj_steps.append(_ldj_sum(cfg, Q))
        sys = sys.replace(vel=vel, g=g, pos=sys.pos + vel * dt).pbc()
        sys = sys.replace(h=sys.h + sys.g * dt)
        ovf = ovf + o
    return sys, torch.stack(ldj_steps).sum(dim=0), ovf


def _lf_reverse(params, cfg: FlowConfig, sys: System):
    dt = cfg.dt
    ldj_steps, ovf = [], 0
    for k in reversed(range(cfg.n_iter)):
        sys = sys.replace(h=sys.h - sys.g * dt)
        sys = sys.replace(pos=sys.pos - sys.vel * dt).pbc()
        (Q, F, G), o = _egcl_at(params, cfg, _index(params["networks"], k),
                                sys)
        sys = sys.replace(g=sys.g - G * dt,
                          vel=(sys.vel - F * dt) / torch.exp(Q))
        ldj_steps.append(-_ldj_sum(cfg, Q))
        ovf = ovf + o
    # the JAX scan emits per-step values in network order: sum in that order
    ldj_steps.reverse()
    return sys, torch.stack(ldj_steps).sum(dim=0), ovf


def _check_dequantizer(cfg: FlowConfig):
    if cfg.dequantizer != "argmax":
        raise NotImplementedError(
            f"dequantizer={cfg.dequantizer!r} is not ported yet (ROADMAP "
            "queue A item 3); the port dequantizes with 'argmax'")


def forward(params, cfg: FlowConfig, sys: System, gen=None, eps=None):
    """Dequantize (ArgMax) and integrate forward: ``(sys, ldj + log_q)``,
    plus the summed overflow when ``cfg.track_overflow`` is set
    (``integrators.py:484-515``). The dequantization noise is ``eps`` when
    given, else a standard normal draw from ``gen``."""
    _check_supported(cfg)
    _check_dequantizer(cfg)
    h, log_q = argmax_deq.forward(params["dequant"], sys.h, sys.mask,
                                  gen=gen, eps=eps)
    sys, ldj, ovf = _lf_forward(params, cfg, sys.replace(h=h))
    if cfg.track_overflow:
        return sys, ldj + log_q, ovf
    return sys, ldj + log_q


def reverse(params, cfg: FlowConfig, sys: System):
    """Integrate backward and re-quantize to one-hot features: the exact
    inverse of :func:`forward` up to its noise. Returns ``sys`` (and the
    summed overflow when ``cfg.track_overflow`` is set)."""
    _check_supported(cfg)
    _check_dequantizer(cfg)
    out, _, ovf = _lf_reverse(params, cfg, sys)
    out = out.replace(h=argmax_deq.reverse(out.h, out.mask))
    return (out, ovf) if cfg.track_overflow else out


def forward_core(params, cfg: FlowConfig, sys: System):
    """Deterministic integrator transform (no dequantization): an exactly
    invertible map over ``(h, g, pos, vel)``; returns ``(sys, ldj [B])``."""
    _check_supported(cfg)
    out = _lf_forward(params, cfg, sys)
    return out if cfg.track_overflow else out[:2]


def reverse_core(params, cfg: FlowConfig, sys: System):
    """Exact inverse of :func:`forward_core`; returns ``(sys, ldj [B])``
    with ldj the log-det of the reverse map. For a latent ``z`` with base
    density ``log p(z)``, ``log q(reverse_core(z)) = log p(z) - ldj``."""
    _check_supported(cfg)
    out = _lf_reverse(params, cfg, sys)
    return out if cfg.track_overflow else out[:2]
