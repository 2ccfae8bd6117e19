"""Thermodynamic integration along the flow bridge, the port of
``enflow_tpu/sample/ti.py``.

``log Z_p - log Z_q0 = int_0^1 E_{x ~ p_beta}[log_p(x) - log_q0(x)] dbeta``
with ``p_beta ∝ q0^(1-beta) p^beta``; with a normalized ``log_q0`` (the
flow pushforward with its exact log-det) the integral is ``log Z_p``. Each
node is a plain expectation under tempered-HMC chains that warm-start from
the previous node, so the estimator has no logsumexp, no reweighting and no
resampling; its errors are the quadrature (estimated by grid halving,
``quad_err``) and each node's burn-in (``n_warmup``).

Validity: the geometric bridge inherits the flow's conditioning at every
node through its ``(1 - beta)`` term. A flow too stiff for it freezes the
``beta = 0`` chains (``accept[0]`` near 0), every node mean collapses to the
initial mean log-weight and the result is no estimate; that case warns.

Batched densities (``[C, ...] -> [C]``), the batched tempered kernel with
the SMC's component caching: a sweep costs ``n_leapfrog`` value-and-grads
of each density. Sweep ``i`` of node ``k`` draws from a generator made
from the node's seed (one per node, drawn up front) and ``i``, so a node
split into ``chunk_steps`` segments equals the monolithic node bit for
bit, and a retried segment draws what its first attempt drew.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .mcmc import batched_value_and_grad, tempered_hmc_kernel_batched
from .mcmc import tree_leaves
from .smc import _ensemble_mass, _generator, _stage_seeds


class TIResult(NamedTuple):
    log_Z: torch.Tensor       # trapezoid estimate of log(Z_p / Z_q0)
    se: torch.Tensor          # across-chain SE, trapezoid-weighted
    quad_err: torch.Tensor    # |full grid - half grid| quadrature estimate
    betas: torch.Tensor       # [K] node grid
    node_mean: torch.Tensor   # [K] E_beta[log_p - log_q0]
    node_se: torch.Tensor     # [K] across-chain SEs of the node means
    accept: torch.Tensor      # [K] mean HMC acceptance per node (kept
                              # sweeps only when adapt_step)
    x: Any                    # final chains (beta = 1: target draws)
    step_size: torch.Tensor = None  # [K] per-node step (chain mean)


def geometric_grid(n_nodes: int, beta_min: float = 0.01):
    """``[0] + geomspace(beta_min, 1, n_nodes - 1)``: the integrand moves
    fastest near ``beta = 0``, so the grid spends its nodes there."""
    if n_nodes < 3:
        raise ValueError(f"n_nodes={n_nodes}; need >= 3")
    return np.concatenate(
        [[0.0], np.geomspace(float(beta_min), 1.0, n_nodes - 1)])


def _trapezoid_weights(betas):
    d = torch.diff(betas)
    w = torch.zeros_like(betas)
    w[:-1] += 0.5 * d
    w[1:] += 0.5 * d
    return w


def _sweep_seed(node_seed: int, i: int) -> int:
    return (node_seed * 1_000_003 + i) % (2 ** 63)


def thermodynamic_integration(
        gen: torch.Generator, x0, *, log_q0: Callable, log_p: Callable,
        betas=None, n_nodes: int = 25, beta_min: float = 0.01,
        n_steps: int = 400, n_warmup: int = 150, step_size: float = 0.08,
        step_size_final: float | None = None, n_leapfrog: int = 5,
        adapt_step: bool = False, target_accept: float = 0.65,
        precondition: bool = False, chunk_steps: int | None = None,
        run_node=None) -> TIResult:
    """Estimate ``log(Z_p / Z_q0)`` by thermodynamic integration.

    - ``x0 [C, ...]``: chains drawn from the proposal (flow draws).
    - ``betas``: an explicit node grid from 0 to 1, else
      :func:`geometric_grid` ``(n_nodes, beta_min)``.
    - ``n_steps`` sweeps a node, the first ``n_warmup`` discarded.
    - ``step_size`` at beta 0, interpolated linearly in beta to
      ``step_size_final`` (default ``step_size / 3``) at beta 1.
    - ``adapt_step``: per-chain multiplicative adaptation (factor
      ``exp(0.15 (accepted - target_accept))``) during each node's warmup
      sweeps only; the adapted steps warm-start the next node, and
      ``accept`` counts the kept sweeps only.
    - ``precondition``: a diagonal mass from the ensemble's spread at each
      node's start (``smc._ensemble_mass``), frozen within the node.
    - ``chunk_steps``: each node's sweeps in segments of at most this
      many, bit for bit equal to the monolithic node.
    - ``run_node(fn, *args)``: wraps every dispatch (cache fill, mass,
      each segment, the node's statistics), the driver's retry hook.
    """
    if betas is None:
        betas = geometric_grid(n_nodes, beta_min)
    betas = np.asarray(betas, np.float64)
    if betas.ndim != 1 or betas.shape[0] < 3:
        raise ValueError(f"betas must be [K>=3]; got shape {betas.shape}")
    if betas[0] != 0.0 or betas[-1] != 1.0 or np.any(np.diff(betas) <= 0):
        raise ValueError("betas must increase from 0 to 1")
    if n_steps <= n_warmup:
        raise ValueError(f"n_steps={n_steps} must exceed n_warmup={n_warmup}")
    eps_final = step_size / 3.0 if step_size_final is None else step_size_final
    vgq = batched_value_and_grad(log_q0)
    vgp = batched_value_and_grad(log_p)
    leaf = tree_leaves(x0)[0]
    C, device = leaf.shape[0], leaf.device
    f32 = dict(dtype=torch.float32, device=device)

    def init_caches(x):
        vq, gq = vgq(x)
        vp, gp = vgp(x)
        return (vq, vp), (gq, gp)

    def node_stats(s_d, n_d, eps):
        cm = s_d / n_d
        return (cm.mean(), cm.std(unbiased=True) / math.sqrt(cm.shape[0]),
                eps.mean())

    @torch.no_grad()
    def seg_fn(node_seed, beta, i0, seg_len, mass, x, vals, grads, eps, acc,
               s_d, n_d):
        for i in range(i0, i0 + seg_len):
            x, a, vals, grads = tempered_hmc_kernel_batched(
                _generator(_sweep_seed(node_seed, i), device), x, vgq, vgp,
                beta, eps, n_leapfrog, vals, grads, mass=mass)
            a_mean = a.to(vals[0].dtype).mean()
            d = vals[1] - vals[0]                      # [C] log_p - log_q0
            keep = float(i >= n_warmup)
            if adapt_step:
                # warmup-only per-chain log-space adaptation; frozen for
                # the kept sweeps
                upd = torch.exp(0.15 * (a.to(eps.dtype) - target_accept))
                if i < n_warmup:
                    eps = eps * upd
                acc = acc + keep * a_mean              # kept sweeps only
            else:
                acc = acc + a_mean
            s_d, n_d = s_d + keep * d, n_d + keep
        return x, vals, grads, eps, acc, s_d, n_d

    run = run_node or (lambda f, *a: f(*a))
    chunk = n_steps if chunk_steps is None else max(1, int(chunk_steps))
    seeds = _stage_seeds(gen, len(betas))
    x = x0
    means, ses, accs, epss = [], [], [], []
    eps_carry = None
    for k, b in enumerate(betas):
        sched = float(step_size * (1.0 - b) + eps_final * b)
        if adapt_step:
            eps = (eps_carry if eps_carry is not None
                   else torch.full((C,), sched, **f32))
        else:
            eps = torch.tensor(sched, **f32)
        beta_t = torch.tensor(b, **f32)
        vals, grads = run(init_caches, x)
        mass = run(_ensemble_mass, x) if precondition else None
        zero = torch.zeros_like(vals[0])
        st = (x, vals, grads, eps, torch.zeros((), **f32), zero, 0.0)
        i0 = 0
        while i0 < n_steps:
            seg_len = min(chunk, n_steps - i0)
            st = run(seg_fn, seeds[k], beta_t, i0, seg_len, mass, *st)
            i0 += seg_len
        x, vals, grads, eps_used, acc, s_d, n_d = st
        denom = (n_steps - n_warmup) if adapt_step else n_steps
        eps_carry = eps_used
        m, s, e_mean = run(node_stats, s_d, n_d, eps_used)
        means.append(float(m))
        ses.append(float(s))
        accs.append(float(acc) / denom)
        epss.append(float(e_mean))

    if accs[0] < 0.1:
        warnings.warn(
            "TI bridge mixing failure: the beta=0 node accepted "
            f"{accs[0]:.0%} of HMC proposals — the proposal-end chains are "
            "frozen and every node mean collapses to the initial mean "
            "log-weight, so the returned log_Z is NOT a valid estimate "
            "(see sample/ti.py 'Validity'). The flow density is too stiff "
            "for the geometric bridge; report a flow-SMC/AIS lower bound "
            "instead.", stacklevel=2)
    f64 = dict(dtype=torch.float64, device=device)
    means_t = torch.tensor(means, **f64)
    ses_t = torch.tensor(ses, **f64)
    bet = torch.tensor(betas, **f64)
    w = _trapezoid_weights(bet)
    log_Z = (w * means_t).sum()
    se = torch.sqrt(((w * ses_t) ** 2).sum())
    # grid-halving quadrature estimate: every other node, endpoints kept
    idx = torch.as_tensor(np.unique(np.r_[0:len(betas):2, len(betas) - 1]),
                          device=device)
    w2 = _trapezoid_weights(bet[idx])
    quad_err = ((w2 * means_t[idx]).sum() - log_Z).abs()
    return TIResult(log_Z=log_Z, se=se, quad_err=quad_err, betas=bet,
                    node_mean=means_t, node_se=ses_t,
                    accept=torch.tensor(accs, **f64), x=x,
                    step_size=torch.tensor(epss, **f64))
