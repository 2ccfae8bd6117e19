"""Invertible leapfrog and velocity-Verlet flows, the port of
``enflow_tpu/flow/integrators.py``.

A Python loop over the per-step EGCL parameters (stacked on a leading
``[n_iter]`` axis, as in the JAX package) takes the place of ``lax.scan``.
LF forward step::

    (Q, F, G) = EGCL_k(h, pos)
    vel  = exp(Q) * vel + F * dt
    g    = g + G * dt
    pos  = pos + vel * dt ;  pbc wrap
    h    = h + g * dt
    ldj += ldj_factor * Q.sum()

and its exact inverse. ``position_update`` 'coupled' and 'drift' add a
second per-step EGCL (``pos_networks``) evaluated on velocity geometry
(``pos := vel``) after the kick, giving a log-scale ``S`` (bounded as
``m tanh(S / m)``, ``m = pos_scale_max / n_iter``) and a shift ``Fp``::

    coupled:  pos = exp(S) * pos + (vel + Fp) * dt ;  ldj += 3 * S.sum()
    drift:    pos = pos + (vel + Fp) * dt           (volume-preserving)

The VV integrator is the JAX package's kick-drift-kick splitting with
``n_iter + 1`` networks and half-kick scale ``exp(Q / 2)``. Ported:
``FlowConfig``, ``init_flow``, ``_egcl_at``, LF (shift, coupled, drift)
and VV ``forward_core``/``reverse_core`` with parity and exact ldj, the
ArgMax and Floor dequantizing ``forward``/``reverse``, in every neighbor
mode of the JAX package (``all_pairs``, ``dense``/``topk``, ``cell`` and
``images``), with ``track_overflow`` (the slots a truncating build dropped,
summed over steps).

Atom sharding: ``axis_name`` holds the collective axis object
(``parallel/collectives.py``) of the atoms, the port's counterpart of the
JAX package's named mesh axis. The system is then this shard's block of
every molecule's atoms (``flow/sharded.py`` builds it): each EGCL is the
ring EGCL (``parallel/ring.py``), taken before any kernel route as in the
JAX package, and the per-molecule log-det sums are ``psum``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..data.neighbors import neighbors_with_diffs
from ..data.system import System
from ..nn import argmax as argmax_deq
from ..nn import floor as floor_deq
from ..nn.egcl import (EGCLConfig, init_egcl, apply_egcl,
                       apply_egcl_fused_allpairs, plain_route)
from ..utils.helpers import LOG_2PI


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
    # the atoms' collective axis object (parallel/collectives.py) when
    # sharded; set by flow/sharded.py
    axis_name: Optional[object] = None
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
    if cfg.integrator not in ("lf", "vv"):
        raise ValueError(cfg.integrator)
    if cfg.position_update not in ("shift", "coupled", "drift"):
        raise ValueError(cfg.position_update)
    if cfg.nbr_mode not in ("all_pairs", "dense", "topk", "cell", "images"):
        raise ValueError(f"unknown nbr_mode {cfg.nbr_mode!r}")
    if cfg.egcl.use_pallas in ("v2", "v3") and cfg.nbr_mode != "all_pairs" \
            and cfg.axis_name is None:
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


def _check_learned_drift(cfg: FlowConfig):
    """The JAX package's guards on a learned position update
    (``integrators.py:429-458``): LF only; 'coupled' raises under a real
    periodic box ('images', 'cell') and warns under 'dense'/'topk'."""
    if cfg.integrator != "lf":
        raise ValueError(
            f"position_update={cfg.position_update!r} is implemented for "
            "the leapfrog integrator only")
    if cfg.position_update != "coupled":
        return
    if cfg.nbr_mode in ("images", "cell"):
        raise ValueError(
            "position_update='coupled' breaks invertibility under a periodic "
            "box (exp(S) does not commute with PBC wrapping); "
            f"nbr_mode={cfg.nbr_mode!r} implies a real periodic box — use "
            "position_update='drift' (the PBC-compatible learned "
            "translation), the shift flow, or an open-boundary nbr_mode")
    if cfg.nbr_mode in ("dense", "topk"):
        import warnings
        warnings.warn(
            "position_update='coupled' is only exact for open boundaries: "
            "ensure box >> |pos| so .pbc() is the identity (nbr_mode "
            "'all_pairs' is the committed cluster recipe; 'drift' is the "
            "PBC-safe variant)", stacklevel=3)


def init_flow(gen: torch.Generator, cfg: FlowConfig, dtype=torch.float32,
              device=None):
    """Flow params: stacked per-step EGCLs + dequantizer parameters, on
    ``device`` (``cuda`` unless the caller asks for another). A learned
    position update ('coupled', 'drift') adds ``pos_networks``, one EGCL per
    LF step whose ``vel_scaling_nn`` and ``coord_nn`` output layers are
    zero, so that the fresh flow is exactly the shift flow."""
    device = resolve_device(device)
    if cfg.integrator not in ("lf", "vv"):
        raise ValueError(cfg.integrator)
    networks = _stack([init_egcl(gen, cfg.egcl, dtype, device)
                       for _ in range(cfg.num_networks)])
    if cfg.dequantizer == "argmax":
        dequant = argmax_deq.init_argmax(gen, cfg.egcl.node_nf,
                                         cfg.egcl.hidden_nf, dtype, device)
    elif cfg.dequantizer == "floor":
        dequant = floor_deq.init_floor()
    else:
        raise ValueError(cfg.dequantizer)
    params = {"networks": networks, "dequant": dequant}
    if cfg.position_update in ("coupled", "drift"):
        _check_learned_drift(cfg)
        pos_nets = []
        for _ in range(cfg.n_iter):
            p = init_egcl(gen, cfg.egcl, dtype, device)
            for head in ("vel_scaling_nn", "coord_nn"):
                p[head][-1] = {k: torch.zeros_like(v)
                               for k, v in p[head][-1].items()}
            pos_nets.append(p)
        params["pos_networks"] = _stack(pos_nets)
    elif cfg.position_update != "shift":
        raise ValueError(cfg.position_update)
    return params


def _egcl_at(params, cfg: FlowConfig, net_params, sys: System):
    """One EGCL on the current state; returns ``((Q, F, G), overflow)``.

    ``all_pairs``: on the card the fused all-pairs kernel (bf16 at every
    N), except for the EGCLs that ``plain_route`` sends to the plain EGCL;
    on the CPU ``use_pallas: v2|v3`` selects the kernel's plain version and
    every other value the plain EGCL (the same function, as in the JAX
    package).
    ``dense``/``topk``, ``cell`` and ``images``: the neighbor list is
    rebuilt from the current positions (with ``capacity``,
    ``cells_per_dim`` and ``cell_capacity``) and the EGCL runs on the
    gathered rows (the gathered-edge kernel on the card); ``overflow``
    counts the slots the build dropped (a device scalar, 0 for the exact
    formats). With ``cfg.axis_name`` the ring EGCL, whatever the route."""
    if cfg.axis_name is not None:
        from ..parallel.ring import ring_egcl
        zero = torch.zeros((), dtype=torch.int32, device=sys.pos.device)
        return ring_egcl(net_params, cfg.egcl, sys.h, sys.pos, sys.mask,
                         sys.box, sys.r_cut, cfg.axis_name,
                         nbr_mode=cfg.nbr_mode), zero
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
                                         cfg.nbr_mode, cfg.cells_per_dim,
                                         cfg.cell_capacity,
                                         with_overflow=True)
    return apply_egcl(net_params, cfg.egcl, sys.h, cd, nbrs.idx, nbrs.mask,
                      sys.mask), ovf


def _atom_sum(cfg: FlowConfig, x):
    """Per-molecule sum over the atoms (``psum``med when sharded)."""
    s = x.sum(dim=(1, 2))
    return s if cfg.axis_name is None else cfg.axis_name.psum(s)


def _ldj_sum(cfg: FlowConfig, Q):
    return cfg.ldj_factor * _atom_sum(cfg, Q)


def _ldj_sum_drift(cfg: FlowConfig, S):
    """The drift's log-scale term: always the exact factor 3, also in NLL
    parity mode (the parity quirk reproduces a reference without a drift
    network), in forward and reverse alike."""
    return 3.0 * _atom_sum(cfg, S)


def _lf_xs(params, cfg: FlowConfig, k: int):
    """Step ``k``'s kick EGCL, and its drift EGCL when a learned position
    update is on (else None)."""
    pnet = (_index(params["pos_networks"], k)
            if cfg.position_update in ("coupled", "drift") else None)
    return _index(params["networks"], k), pnet


def _drift_egcl(params, cfg: FlowConfig, pnet, sys: System):
    """The drift EGCL on velocity geometry (``pos := vel``): its input
    ``(vel, h)`` is what the drift leaves unchanged, so forward and reverse
    see the same ``(S, Fp)``. Returns ``(m tanh(S / m), Fp, overflow)``
    with ``m = pos_scale_max / n_iter``. In ``all_pairs`` mode on the card
    it is one more fused-kernel EGCL; the min-image wrap of the kernel
    applies to the velocity differences against the same box."""
    (S, Fp, _), ovf = _egcl_at(params, cfg, pnet, sys.replace(pos=sys.vel))
    m = cfg.pos_scale_max / cfg.n_iter
    return m * torch.tanh(S / m), Fp, ovf


def _lf_forward(params, cfg: FlowConfig, sys: System):
    dt = cfg.dt
    coupled = cfg.position_update == "coupled"
    ldj_steps, ovf = [], 0
    for k in range(cfg.n_iter):
        net, pnet = _lf_xs(params, cfg, k)
        (Q, F, G), o = _egcl_at(params, cfg, net, sys)
        vel = torch.exp(Q) * sys.vel + F * dt
        g = sys.g + G * dt
        ldj = _ldj_sum(cfg, Q)
        if pnet is not None:
            S, Fp, o2 = _drift_egcl(params, cfg, pnet, sys.replace(vel=vel))
            if coupled:
                pos = torch.exp(S) * sys.pos + (vel + Fp) * dt
                ldj = ldj + _ldj_sum_drift(cfg, S)
            else:       # 'drift': a translation, volume-preserving
                pos = sys.pos + (vel + Fp) * dt
            o = o + o2
        else:
            pos = sys.pos + vel * dt
        ldj_steps.append(ldj)
        sys = sys.replace(vel=vel, g=g, pos=pos).pbc()
        sys = sys.replace(h=sys.h + sys.g * dt)
        ovf = ovf + o
    return sys, torch.stack(ldj_steps).sum(dim=0), ovf


def _lf_reverse(params, cfg: FlowConfig, sys: System):
    dt = cfg.dt
    coupled = cfg.position_update == "coupled"
    ldj_steps, ovf = [], 0
    for k in reversed(range(cfg.n_iter)):
        net, pnet = _lf_xs(params, cfg, k)
        sys = sys.replace(h=sys.h - sys.g * dt)
        ldj2 = 0.0
        if pnet is not None:
            S, Fp, o2 = _drift_egcl(params, cfg, pnet, sys)
            if coupled:
                pos = (sys.pos - (sys.vel + Fp) * dt) * torch.exp(-S)
                ldj2 = -_ldj_sum_drift(cfg, S)
            else:
                pos = sys.pos - (sys.vel + Fp) * dt
            ovf = ovf + o2
        else:
            pos = sys.pos - sys.vel * dt
        sys = sys.replace(pos=pos).pbc()
        (Q, F, G), o = _egcl_at(params, cfg, net, sys)
        sys = sys.replace(g=sys.g - G * dt,
                          vel=(sys.vel - F * dt) / torch.exp(Q))
        ldj_steps.append(-_ldj_sum(cfg, Q) + ldj2)
        ovf = ovf + o
    # the JAX scan emits per-step values in network order: sum in that order
    ldj_steps.reverse()
    return sys, torch.stack(ldj_steps).sum(dim=0), ovf


def _vv_forward(params, cfg: FlowConfig, sys: System):
    """Kick-drift-kick with ``n_iter + 1`` networks; each step's second
    half-kick evaluation is carried into the next step's first."""
    dt, dt_2 = cfg.dt, cfg.dt / 2
    nets = params["networks"]
    (Q, F, G), ovf = _egcl_at(params, cfg, _index(nets, 0), sys)
    ldj_steps = []
    for k in range(1, cfg.n_iter + 1):
        vel = torch.exp(Q / 2) * sys.vel + F * dt_2
        g = sys.g + G * dt_2
        ldj = 0.5 * _ldj_sum(cfg, Q)
        sys = sys.replace(vel=vel, g=g, pos=sys.pos + vel * dt).pbc()
        sys = sys.replace(h=sys.h + sys.g * dt)
        (Q, F, G), o = _egcl_at(params, cfg, _index(nets, k), sys)
        sys = sys.replace(vel=torch.exp(Q / 2) * sys.vel + F * dt_2,
                          g=sys.g + G * dt_2)
        ldj_steps.append(ldj + 0.5 * _ldj_sum(cfg, Q))
        ovf = ovf + o
    return sys, torch.stack(ldj_steps).sum(dim=0), ovf


def _vv_reverse(params, cfg: FlowConfig, sys: System):
    """The exact mirror of :func:`_vv_forward`: half-kicks leave ``(h,
    pos)`` unchanged, so network k's evaluation after undoing step k serves
    both that step's first half-kick and step k-1's second."""
    dt, dt_2 = cfg.dt, cfg.dt / 2
    nets = params["networks"]
    (Q, F, G), ovf = _egcl_at(params, cfg, _index(nets, cfg.n_iter), sys)
    ldj_steps = []
    for k in reversed(range(cfg.n_iter)):
        sys = sys.replace(g=sys.g - G * dt_2,
                          vel=(sys.vel - F * dt_2) / torch.exp(Q / 2))
        ldj = -0.5 * _ldj_sum(cfg, Q)
        sys = sys.replace(h=sys.h - sys.g * dt)
        sys = sys.replace(pos=sys.pos - sys.vel * dt).pbc()
        (Q, F, G), o = _egcl_at(params, cfg, _index(nets, k), sys)
        sys = sys.replace(g=sys.g - G * dt_2,
                          vel=(sys.vel - F * dt_2) / torch.exp(Q / 2))
        ldj_steps.append(ldj - 0.5 * _ldj_sum(cfg, Q))
        ovf = ovf + o
    ldj_steps.reverse()
    return sys, torch.stack(ldj_steps).sum(dim=0), ovf


def _core(cfg: FlowConfig, reverse: bool):
    _check_supported(cfg)
    if cfg.integrator == "vv":
        return _vv_reverse if reverse else _vv_forward
    return _lf_reverse if reverse else _lf_forward


def forward(params, cfg: FlowConfig, sys: System, gen=None, eps=None):
    """Dequantize and integrate forward: ``(sys, ldj + log_q)``, plus the
    summed overflow when ``cfg.track_overflow`` is set
    (``integrators.py:735-766``). The dequantization noise is ``eps`` when
    given (standard normal for ArgMax, ``U[0, 1)`` for Floor), else a draw
    from ``gen``.

    Atom-sharded (``cfg.axis_name``), ``eps`` is this shard's block of the
    noise (``flow/sharded.py`` draws the whole molecules' and splits it), so
    each shard dequantizes its own atoms with its own draws; ``log_q``'s
    partial sums are ``psum``med, the ArgMax ``log(2 pi)`` charged once a
    molecule and not once a shard."""
    integrate = _core(cfg, reverse=False)
    ax = cfg.axis_name
    if ax is not None and eps is None:
        raise ValueError("an atom-sharded forward takes its shard's noise "
                         "as eps (flow/sharded.py draws it)")
    if cfg.dequantizer == "argmax":
        h, log_q = argmax_deq.forward(params["dequant"], sys.h, sys.mask,
                                      gen=gen, eps=eps)
    else:
        h, log_q = floor_deq.forward(cfg.dequant_scale, sys.h, sys.mask,
                                     gen=gen, noise=eps)
    if ax is not None:
        log_q = ax.psum(log_q)
        if cfg.dequantizer == "argmax":
            log_q = log_q + 0.5 * LOG_2PI * (ax.size - 1)
    sys, ldj, ovf = integrate(params, cfg, sys.replace(h=h))
    if cfg.track_overflow:
        return sys, ldj + log_q, ovf
    return sys, ldj + log_q


def reverse(params, cfg: FlowConfig, sys: System):
    """Integrate backward and re-quantize (one-hot argmax, or floor): the
    exact inverse of :func:`forward` up to its noise. Returns ``sys`` (and
    the summed overflow when ``cfg.track_overflow`` is set)."""
    out, _, ovf = _core(cfg, reverse=True)(params, cfg, sys)
    deq = argmax_deq if cfg.dequantizer == "argmax" else floor_deq
    out = out.replace(h=deq.reverse(out.h, out.mask))
    return (out, ovf) if cfg.track_overflow else out


def forward_core(params, cfg: FlowConfig, sys: System):
    """Deterministic integrator transform (no dequantization): an exactly
    invertible map over ``(h, g, pos, vel)``; returns ``(sys, ldj [B])``."""
    out = _core(cfg, reverse=False)(params, cfg, sys)
    return out if cfg.track_overflow else out[:2]


def reverse_core(params, cfg: FlowConfig, sys: System):
    """Exact inverse of :func:`forward_core`; returns ``(sys, ldj [B])``
    with ldj the log-det of the reverse map. For a latent ``z`` with base
    density ``log p(z)``, ``log q(reverse_core(z)) = log p(z) - ldj``."""
    out = _core(cfg, reverse=True)(params, cfg, sys)
    return out if cfg.track_overflow else out[:2]
