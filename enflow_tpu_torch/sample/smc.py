"""Sequential Monte Carlo and annealed importance sampling, the port of
``enflow_tpu/sample/smc.py``: ``smc``, its chunked and resumable form
``smc_segments``, and ``ais``.

Always batched: ``log_q0``/``log_p`` map the whole ``[P, ...]`` particle
state to ``[P]`` in one call, so the fused EGCL kernel sees every particle
at once. The component caches of the JAX package are kept, so a run costs
exactly ``1 + n_temps * mcmc_steps * n_leapfrog`` value-and-grads of each
density (plus the caller's proposal). Everything outside those
value-and-grads runs under ``torch.no_grad()`` on detached particles, so no
autograd graph grows across temperatures. A Python loop takes the place of
``lax.scan``; ``torch.Generator``s take the place of PRNG keys.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .mcmc import (batched_value_and_grad, tempered_hmc_kernel_batched,
                   tree_map)


def ess_from_log_weights(log_w: torch.Tensor) -> torch.Tensor:
    """Kish effective sample size of normalized importance weights."""
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * log_w, dim=0))


def systematic_resample(log_w: torch.Tensor, n: int | None = None, *,
                        uniform=None, generator: torch.Generator | None = None):
    """Systematic resampling: ``[n]`` particle indices.

    ``uniform`` is the comb's single ``U(0, 1)`` draw (drawn from
    ``generator`` when not given); the teeth sit at ``(uniform + k) / n``."""
    p = log_w.shape[0]
    n = n or p
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    cdf = torch.cumsum(torch.exp(log_w), dim=0)
    if uniform is None:
        uniform = torch.rand((), generator=generator, dtype=log_w.dtype,
                             device=log_w.device)
    u0 = torch.as_tensor(uniform, dtype=log_w.dtype, device=log_w.device) / n
    u = u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device) / n
    return torch.searchsorted(cdf, u).clamp(0, p - 1)


class SMCResult(NamedTuple):
    particles: object
    log_weights: torch.Tensor
    log_Z: torch.Tensor
    ess_history: torch.Tensor
    accept_history: torch.Tensor
    beta_history: torch.Tensor | None = None
    step_history: torch.Tensor | None = None
    stage_metric_history: torch.Tensor | None = None


def _adaptive_delta(log_w, d, beta_prev, target_ess, n_bisect: int = 26):
    """Largest temperature increment whose incremental ESS is at least
    ``target_ess`` (bisection on ``[0, 1 - beta_prev]``)."""
    hi0 = 1.0 - beta_prev

    def ess_at(delta):
        return ess_from_log_weights(log_w + delta * d)

    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target_ess
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(ess_at(hi0) >= target_ess, hi0, lo)


def _init_component_caches(log_q0, log_p, x0, mcmc_steps):
    """Values (and, when HMC will run, gradients) of both density
    components at the initial particles."""
    if mcmc_steps > 0:
        lq0, glq0 = batched_value_and_grad(log_q0)(x0)
        lp, glp = batched_value_and_grad(log_p)(x0)
        return lq0, lp, glq0, glp
    return log_q0(x0), log_p(x0), None, None


def _ensemble_mass(x):
    """Per-coordinate momentum scales from the ensemble: the std across
    particles, floored at 5% of the leaf RMS."""
    def leaf_mass(a):
        s = a.std(dim=0, unbiased=False)
        rms = torch.sqrt((a * a).mean())
        return torch.maximum(s, 0.05 * rms + 1e-6)
    return tree_map(leaf_mass, x)


def _rejuvenate(gen, x, beta, vals, grads, *, log_q0, log_p, mcmc_steps,
                step_size, n_leapfrog, mass=None):
    """``mcmc_steps`` tempered-HMC sweeps threading the component caches.
    Returns ``(x, mean_accept, vals, grads)``."""
    if mcmc_steps <= 0:
        return x, 0.0, vals, grads
    vgq = batched_value_and_grad(log_q0)
    vgp = batched_value_and_grad(log_p)
    acc = 0.0
    for _ in range(mcmc_steps):
        x, accepted, vals, grads = tempered_hmc_kernel_batched(
            gen, x, vgq, vgp, beta, step_size, n_leapfrog, vals, grads,
            mass=mass)
        acc = acc + accepted.to(vals[0].dtype).mean()
    return x, acc / mcmc_steps, vals, grads


def _adapted_step(step_size, accept, target_accept, gain: float = 1.0):
    return step_size * torch.exp(gain * (accept - target_accept))


def _take(tree, idx):
    return None if tree is None else tree_map(lambda a: a[idx], tree)


def _make_anneal_step(log_q0, log_p, *, P, adaptive, target_ess_frac,
                      mcmc_steps, n_leapfrog, resample_threshold, adapt_step,
                      target_accept, precondition, stage_fn=None):
    """The per-temperature SMC transition ``(carry, (beta, beta_prev, gen))
    -> (carry, (ess, accept, beta, eps[, metric]))``. ``stage_fn``
    (optional): ``particles -> scalar tensor`` on the post-rejuvenation
    particles of every stage, its value the history's fifth entry (kept on
    the device; no host read)."""

    def anneal_step(carry, inputs):
        (x, log_w, log_z, beta_carry, eps,
         lq0_x, lp_x, glq0_x, glp_x) = carry
        beta_sched, beta_prev_sched, gen = inputs
        d = lp_x - lq0_x
        if adaptive:
            beta_prev = beta_carry
            delta = _adaptive_delta(log_w, d, beta_prev, target_ess_frac * P)
            beta = beta_prev + delta
        else:
            beta, beta_prev = beta_sched, beta_prev_sched
            delta = beta - beta_prev
        log_w = log_w + delta * d
        lse = torch.logsumexp(log_w, dim=0)
        log_z = log_z + lse
        log_w = log_w - lse
        ess = ess_from_log_weights(log_w)

        # adaptive systematic resampling, caches gathered alongside; the
        # comb is drawn every stage (as the JAX key split is) and applied
        # as the identity gather when no resampling is due
        resample_now = ess < resample_threshold * P
        if adaptive:
            resample_now = resample_now | (beta < 1.0 - 1e-9)
        idx = systematic_resample(log_w, generator=gen)
        idx = torch.where(resample_now, idx,
                          torch.arange(P, device=idx.device))
        x, lq0_x, lp_x = _take(x, idx), lq0_x[idx], lp_x[idx]
        glq0_x, glp_x = _take(glq0_x, idx), _take(glp_x, idx)
        log_w = torch.where(resample_now,
                            torch.full_like(log_w, -math.log(P)), log_w)

        x, acc, (lq0_x, lp_x), (glq0_x, glp_x) = _rejuvenate(
            gen, x, beta, (lq0_x, lp_x), (glq0_x, glp_x),
            log_q0=log_q0, log_p=log_p, mcmc_steps=mcmc_steps,
            step_size=eps, n_leapfrog=n_leapfrog,
            mass=_ensemble_mass(x) if precondition else None)
        acc = torch.as_tensor(acc, dtype=log_w.dtype, device=log_w.device)
        eps_next = (_adapted_step(eps, acc, target_accept)
                    if (adapt_step and mcmc_steps > 0) else eps)
        hist = (ess, acc, beta, eps)
        if stage_fn is not None:
            hist = hist + (stage_fn(x),)
        return ((x, log_w, log_z, beta, eps_next,
                 lq0_x, lp_x, glq0_x, glp_x), hist)

    return anneal_step


def _schedule(n_temps, betas, dtype, device):
    if betas is None:
        betas = torch.linspace(1.0 / n_temps, 1.0, n_temps, dtype=dtype,
                               device=device)
    else:
        betas = torch.as_tensor(betas, dtype=dtype, device=device)
    betas_prev = torch.cat([torch.zeros((1,), dtype=dtype, device=device),
                            betas[:-1]])
    return betas, betas_prev


def _stage_seeds(gen: torch.Generator, n: int):
    """One seed per stage, drawn from ``gen`` (the JAX key split)."""
    return torch.randint(0, 2 ** 62, (n,), generator=gen,
                         device=gen.device).tolist()


def _generator(seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _state_meta(x0):
    leaf = x0[sorted(x0)[0]] if isinstance(x0, dict) else x0
    return leaf.shape[0], leaf.dtype, leaf.device


def smc(gen: torch.Generator, x0, *, log_q0: Callable, log_p: Callable,
        n_temps: int = 10, betas=None, adaptive: bool = False,
        target_ess_frac: float = 0.6, mcmc_steps: int = 2, step_size=0.05,
        n_leapfrog: int = 5, resample_threshold: float = 0.5,
        adapt_step: bool = False, target_accept: float = 0.65,
        precondition: bool = False, stage_fn=None) -> SMCResult:
    """Tempered SMC from proposal samples ``x0 [P, ...]`` to the target
    ``log_p``, over ``log pi_beta = (1-beta) log_q0 + beta log_p``; the
    arguments are those of the JAX package's ``smc`` (always batched).
    ``log_Z`` estimates ``log(Z_p / Z_q0)``. ``stage_fn`` (optional):
    ``particles -> scalar`` on every stage's particles after the
    rejuvenation, stacked into ``stage_metric_history``. It is
    :func:`smc_segments` with one segment."""
    return smc_segments(
        gen, x0, log_q0=log_q0, log_p=log_p, n_temps=n_temps, betas=betas,
        adaptive=adaptive, target_ess_frac=target_ess_frac,
        mcmc_steps=mcmc_steps, step_size=step_size, n_leapfrog=n_leapfrog,
        resample_threshold=resample_threshold, adapt_step=adapt_step,
        target_accept=target_accept, precondition=precondition,
        stage_fn=stage_fn, chunk_temps=0)


@torch.no_grad()
def smc_segments(gen: torch.Generator, x0, *, log_q0: Callable,
                 log_p: Callable, n_temps: int = 10, betas=None,
                 adaptive: bool = False, target_ess_frac: float = 0.6,
                 mcmc_steps: int = 2, step_size=0.05, n_leapfrog: int = 5,
                 resample_threshold: float = 0.5, adapt_step: bool = False,
                 target_accept: float = 0.65, precondition: bool = False,
                 stage_fn=None,
                 chunk_temps: int = 4, run_segment=None, on_segment=None,
                 start_stage: int = 0, init_state=None,
                 init_hists=None) -> SMCResult:
    """:func:`smc` run as segments of at most ``chunk_temps`` temperatures
    (``<= 0``: one segment), the state held between them, so that a caller
    can retry a failed segment or persist the state and resume a killed run
    (``enflow_tpu/sample/smc.py:352-459``).

    Every stage applies the same transition with a generator made from its
    own seed (all seeds drawn from ``gen`` up front, as the JAX key split),
    so the result equals :func:`smc`'s bit for bit, a resumed run equals an
    uninterrupted one, and a retried segment draws what its first attempt
    drew. The transition does not write into the carry it is given.

    - ``run_segment``: executor ``f(fn, *args) -> fn(*args)`` around the
      initialization and every segment (the driver's retry hook).
    - ``on_segment(next_stage, state, hists)``: called after each segment
      with the carry ``(x, log_w, log_z, beta, eps, lq0, lp, glq0, glp)``
      and the per-segment histories ``[(ess, accept, beta, eps[, metric]),
      ...]`` (the metric with a ``stage_fn``).
    - ``start_stage`` / ``init_state`` / ``init_hists``: resume from what
      ``on_segment`` saw; ``x0`` may be None then. Histories without a
      metric (a state file written without ``stage_fn``) count 0 for it.
    """
    if init_state is not None:
        x_meta = init_state[0]
    else:
        x_meta = x0
    P, dtype, device = _state_meta(x_meta)
    if betas is not None:
        n_temps = len(betas)
    betas, betas_prev = _schedule(n_temps, betas, dtype, device)
    seeds = _stage_seeds(gen, n_temps)
    if chunk_temps <= 0:
        chunk_temps = n_temps
    run = run_segment or (lambda f, *a: f(*a))
    step = _make_anneal_step(
        log_q0, log_p, P=P, adaptive=adaptive,
        target_ess_frac=target_ess_frac, mcmc_steps=mcmc_steps,
        n_leapfrog=n_leapfrog, resample_threshold=resample_threshold,
        adapt_step=adapt_step, target_accept=target_accept,
        precondition=precondition, stage_fn=stage_fn)

    def init_fn(x0):
        zero = torch.zeros((), dtype=dtype, device=device)
        return (x0, torch.full((P,), -math.log(P), dtype=dtype,
                               device=device),
                zero, zero, torch.as_tensor(step_size, dtype=dtype,
                                            device=device)) + \
            _init_component_caches(log_q0, log_p, x0, mcmc_steps)

    def seg_fn(carry, i, j):
        # each stage's generator is made here from its seed, so a retried
        # segment draws what its first attempt drew
        hist = []
        for k in range(i, j):
            carry, h = step(carry, (betas[k], betas_prev[k],
                                    _generator(seeds[k], device)))
            hist.append(h)
        return carry, tuple(torch.stack(c) for c in zip(*hist))

    state = run(init_fn, x0) if init_state is None else init_state
    hists = list(init_hists) if init_hists else []
    i = int(start_stage)
    while i < n_temps:
        j = min(i + chunk_temps, n_temps)
        state, hist = run(seg_fn, state, i, j)
        hists.append(hist)
        if on_segment is not None:
            on_segment(j, state, hists)
        i = j
    if stage_fn is not None:
        hists = [h if len(h) > 4 else h + (torch.zeros(
            h[0].shape, dtype=torch.int32, device=h[0].device),)
            for h in hists]
    ess_h, acc_h, beta_h, step_h, *metric_h = (
        torch.cat([h[c] for h in hists])
        for c in range(5 if stage_fn is not None else 4))
    return SMCResult(particles=state[0], log_weights=state[1],
                     log_Z=state[2], ess_history=ess_h, accept_history=acc_h,
                     beta_history=beta_h, step_history=step_h,
                     stage_metric_history=metric_h[0] if metric_h else None)


@torch.no_grad()
def ais(gen: torch.Generator, x0, *, log_q0: Callable, log_p: Callable,
        n_temps: int = 10, betas=None, mcmc_steps: int = 2, step_size=0.05,
        n_leapfrog: int = 5, adapt_step: bool = False,
        target_accept: float = 0.65,
        precondition: bool = False, stage_fn=None) -> SMCResult:
    """Annealed importance sampling: the SMC machinery without resampling;
    ``log_Z`` is ``logmeanexp(log_w)``; ``stage_fn`` as in :func:`smc`."""
    P, dtype, device = _state_meta(x0)
    if betas is not None:
        n_temps = len(betas)
    betas, betas_prev = _schedule(n_temps, betas, dtype, device)
    lq0_x, lp_x, glq0_x, glp_x = _init_component_caches(log_q0, log_p, x0,
                                                        mcmc_steps)
    x = x0
    log_w = torch.zeros((P,), dtype=dtype, device=device)
    eps = torch.as_tensor(step_size, dtype=dtype, device=device)
    ess_h, acc_h, step_h, metric_h = [], [], [], []
    for k, seed in enumerate(_stage_seeds(gen, n_temps)):
        g = _generator(seed, device)
        log_w = log_w + (betas[k] - betas_prev[k]) * (lp_x - lq0_x)
        x, acc, (lq0_x, lp_x), (glq0_x, glp_x) = _rejuvenate(
            g, x, betas[k], (lq0_x, lp_x), (glq0_x, glp_x),
            log_q0=log_q0, log_p=log_p, mcmc_steps=mcmc_steps,
            step_size=eps, n_leapfrog=n_leapfrog,
            mass=_ensemble_mass(x) if precondition else None)
        acc = torch.as_tensor(acc, dtype=dtype, device=device)
        step_h.append(eps)
        if adapt_step and mcmc_steps > 0:
            eps = _adapted_step(eps, acc, target_accept)
        ess_h.append(ess_from_log_weights(log_w))
        acc_h.append(acc)
        if stage_fn is not None:
            metric_h.append(stage_fn(x))
    log_z = torch.logsumexp(log_w, dim=0) - math.log(P)
    return SMCResult(particles=x, log_weights=log_w, log_Z=log_z,
                     ess_history=torch.stack(ess_h),
                     accept_history=torch.stack(acc_h),
                     step_history=torch.stack(step_h),
                     stage_metric_history=(torch.stack(metric_h)
                                           if metric_h else None))
