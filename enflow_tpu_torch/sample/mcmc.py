"""MCMC kernels, the port of ``enflow_tpu/sample/mcmc.py``.

Particle states are a tensor ``[P, ...]`` or a dict of such tensors (the
JAX package's pytrees; dict leaves are visited in sorted key order, as JAX
flattens them). ``torch.Generator``s take the place of PRNG keys, and a
host loop the place of ``lax.scan``. Densities are batched, ``[P, ...] ->
[P]``: the JAX package's per-chain kernels, vmapped over chains, become
kernels over all chains at once whose chains stay independent (a per-chain
accept, per-chain energies).

Each kernel has a core that takes its random draws explicitly (momenta,
the MALA noise, the acceptance uniforms) beside a wrapper that draws them
from a generator, momenta first, so a test can replay the JAX package's
draws through the core. Ported: ``batched_value_and_grad``, the batched
tempered-HMC kernel with its optional diagonal ``mass`` (per-particle
``beta`` / ``step_size`` vectors broadcast), ``hmc_kernel``,
``mala_kernel``, ``run_hmc``, ``dual_averaging_warmup``, ``run_mala``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over tensors or dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [tree]


def batched_value_and_grad(f: Callable) -> Callable:
    """``f`` maps a ``[P, ...]`` state to ``[P]`` log-densities; returns
    ``x -> (vals [P], grads)`` with one ones-cotangent backward pass.

    The input is detached and marked ``requires_grad`` (no ``create_graph``),
    and values and gradients come back detached, so no graph outlives the
    call."""

    def vg(x):
        with torch.enable_grad():
            xs = tree_map(lambda a: a.detach().requires_grad_(True), x)
            vals = f(xs)
            leaves = tree_leaves(xs)
            grads = torch.autograd.grad(vals.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(leaves, grads)]
        if isinstance(xs, dict):
            grads = dict(zip(sorted(xs), grads))
        else:
            grads = grads[0]
        return vals.detach(), grads

    return vg


def _coef(v, leaf: torch.Tensor):
    """A scalar or per-particle ``[P]`` coefficient, cast to the leaf's dtype
    and shaped to broadcast against ``leaf [P, ...]``."""
    if not isinstance(v, torch.Tensor):
        return v
    v = v.to(leaf.dtype)
    return v if v.ndim == 0 else v.reshape(v.shape + (1,) * (leaf.ndim - 1))


def _axpy(alpha, x, y):
    return tree_map(lambda a, b: _coef(alpha, a) * a + b, x, y)


def _dot_batched(a, b):
    """Per-particle inner product over the leaves: ``[P]``."""
    return sum((x * y).sum(dim=tuple(range(1, x.ndim)))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def randn_like(gen: torch.Generator, x):
    """Standard normal draws shaped as the state ``x``, leaf by leaf in
    sorted key order (the JAX package's ``_tree_randn_like``)."""
    return tree_map(lambda a: torch.randn(a.shape, generator=gen,
                                          dtype=a.dtype, device=a.device), x)


def _uniform(gen: torch.Generator, like: torch.Tensor):
    return torch.rand(like.shape, generator=gen, dtype=like.dtype,
                      device=like.device)


def _select(accept, a, b):
    """``a`` where the per-particle ``accept [P]`` holds, else ``b``."""
    return tree_map(lambda s, t: torch.where(
        accept.reshape(accept.shape + (1,) * (s.ndim - 1)), s, t), a, b)


def tempered_hmc_step(x, p0, uniform, vgq: Callable, vgp: Callable, beta,
                      step_size, n_leapfrog: int, vals, grads, mass=None):
    """The core of :func:`tempered_hmc_kernel_batched` with its draws given:
    the standard normal momenta ``p0`` (shaped as ``x``, before the mass
    scaling) and the acceptance uniforms ``uniform [P]``."""
    w0, w1 = 1.0 - beta, beta

    def comb(gq, gp):
        return tree_map(lambda a, b: _coef(w0, a) * a + _coef(w1, b) * b,
                        gq, gp)

    if mass is not None:
        p0 = tree_map(lambda n, s: n / s.to(n.dtype), p0, mass)

        def drift(q, p):
            return tree_map(lambda qq, pp, s: qq + _coef(step_size, qq)
                            * (s * s).to(qq.dtype) * pp, q, p, mass)

        def kinetic(p):
            ps = tree_map(lambda pp, s: pp * s.to(pp.dtype), p, mass)
            return _dot_batched(ps, ps)
    else:
        def drift(q, p):
            return _axpy(step_size, p, q)

        def kinetic(p):
            return _dot_batched(p, p)

    q, p = x, p0
    gq, gp = grads
    vq, vp = vals
    half = 0.5 * step_size
    for _ in range(n_leapfrog):
        p = _axpy(half, comb(gq, gp), p)
        q = drift(q, p)
        vq, gq = vgq(q)
        vp, gp = vgp(q)
        p = _axpy(half, comb(gq, gp), p)

    lp0 = _coef(w0, vals[0]) * vals[0] + _coef(w1, vals[1]) * vals[1]
    lp1 = _coef(w0, vq) * vq + _coef(w1, vp) * vp
    h0 = -lp0 + 0.5 * kinetic(p0)
    h1 = -lp1 + 0.5 * kinetic(p)
    accept = torch.log(uniform) < h0 - h1

    x_out = _select(accept, q, x)
    vals_out = (torch.where(accept, vq, vals[0]),
                torch.where(accept, vp, vals[1]))
    grads_out = (_select(accept, gq, grads[0]), _select(accept, gp, grads[1]))
    return x_out, accept, vals_out, grads_out


def tempered_hmc_kernel_batched(gen: torch.Generator, x, vgq: Callable,
                                vgp: Callable, beta, step_size,
                                n_leapfrog: int, vals, grads, mass=None):
    """One HMC step over all particles targeting
    ``(1-beta) log_q0 + beta log_p``, reusing the cached component values
    ``vals = (lq0, lp)`` and gradients ``grads = (glq0, glp)`` at ``x``.

    Each call costs exactly ``n_leapfrog`` value-and-grads of each
    component. ``beta`` and ``step_size`` are scalars or per-particle
    ``[P]`` vectors (batched REMC's per-replica ladder). ``mass``: optional
    per-coordinate position scales ``s`` (``M = diag(1/s^2)``), broadcast
    across particles. Draws the momenta, then the uniforms, from ``gen``.
    Returns ``(x', accepted [P], vals', grads')`` with the caches at the
    accepted state."""
    p0 = randn_like(gen, x)
    u = _uniform(gen, vals[0])
    return tempered_hmc_step(x, p0, u, vgq, vgp, beta, step_size, n_leapfrog,
                             vals, grads, mass=mass)


# ---------------------------------------------------------------------------
# per-chain kernels (independent chains, batched densities)
# ---------------------------------------------------------------------------

def hmc_step(x, p0, uniform, vg: Callable, step_size, n_leapfrog: int,
             log_prob_x=None, grad_x=None):
    """The core of :func:`hmc_kernel` with its draws given (momenta ``p0``
    shaped as ``x``, acceptance uniforms ``[C]``). ``vg`` is a batched
    value-and-grad; ``log_prob_x`` / ``grad_x`` are the density and its
    gradient at ``x`` when the caller has them. The force between adjacent
    leapfrog steps is computed once. Returns ``(x', accepted [C],
    log_prob', grad')``."""
    if log_prob_x is None or grad_x is None:
        lp_x, g_x = vg(x)
        log_prob_x = lp_x if log_prob_x is None else log_prob_x
        grad_x = g_x if grad_x is None else grad_x
    q, p, g = x, p0, grad_x
    lp1 = log_prob_x
    half = 0.5 * step_size
    for _ in range(n_leapfrog):
        p = _axpy(half, g, p)
        q = _axpy(step_size, p, q)
        lp1, g = vg(q)
        p = _axpy(half, g, p)
    h0 = -log_prob_x + 0.5 * _dot_batched(p0, p0)
    h1 = -lp1 + 0.5 * _dot_batched(p, p)
    accept = torch.log(uniform) < h0 - h1
    return (_select(accept, q, x), accept,
            torch.where(accept, lp1, log_prob_x), _select(accept, g, grad_x))


def hmc_kernel(gen: torch.Generator, x, log_prob: Callable, step_size,
               n_leapfrog: int, log_prob_x=None):
    """One HMC step for every chain of ``x [C, ...]`` on the batched
    density ``log_prob``. Returns ``(x', accepted [C], log_prob')``."""
    p0 = randn_like(gen, x)
    x, acc, lp, _ = hmc_step(x, p0, _chain_uniform(gen, x),
                             batched_value_and_grad(log_prob), step_size,
                             n_leapfrog, log_prob_x=log_prob_x)
    return x, acc, lp


def _value_dtype(x):
    return tree_leaves(x)[0].dtype


def _chain_uniform(gen, x):
    """One ``U(0, 1)`` draw per chain of ``x [C, ...]``."""
    leaf = tree_leaves(x)[0]
    return torch.rand((leaf.shape[0],), generator=gen, dtype=leaf.dtype,
                      device=leaf.device)


def _sq_dist(a, b):
    return sum(((u - v) ** 2).sum(dim=tuple(range(1, u.ndim)))
               for u, v in zip(tree_leaves(a), tree_leaves(b)))


def mala_step(x, noise, uniform, vg: Callable, step_size, log_prob_x=None,
              grad_x=None):
    """The core of :func:`mala_kernel` with its draws given (the proposal
    noise shaped as ``x``, acceptance uniforms ``[C]``). Returns ``(x',
    accepted [C], log_prob', grad')``."""
    if log_prob_x is None or grad_x is None:
        log_prob_x, grad_x = vg(x)
    mean_fwd = _axpy(step_size, grad_x, x)
    scale = (torch.sqrt(2.0 * step_size) if isinstance(step_size,
                                                       torch.Tensor)
             else math.sqrt(2.0 * step_size))
    prop = _axpy(scale, noise, mean_fwd)
    lp_prop, g_prop = vg(prop)
    mean_rev = _axpy(step_size, g_prop, prop)
    log_alpha = (lp_prop - log_prob_x
                 + (-_sq_dist(x, mean_rev) + _sq_dist(prop, mean_fwd))
                 / (4.0 * step_size))
    accept = torch.log(uniform) < log_alpha
    return (_select(accept, prop, x), accept,
            torch.where(accept, lp_prop, log_prob_x),
            _select(accept, g_prop, grad_x))


def mala_kernel(gen: torch.Generator, x, log_prob: Callable, step_size):
    """One Metropolis-adjusted Langevin step for every chain of ``x [C,
    ...]``. Returns ``(x', accepted [C])``."""
    noise = randn_like(gen, x)
    x, acc, _, _ = mala_step(x, noise, _chain_uniform(gen, x),
                             batched_value_and_grad(log_prob), step_size)
    return x, acc


class HMCResult(NamedTuple):
    samples: object          # [n_samples, C, ...] (dict leaves stacked)
    final_state: object      # [C, ...]
    accept_rate: torch.Tensor


def _stack(states):
    return tree_map(lambda *a: torch.stack(a), *states)


def _chains(x0):
    return tree_leaves(x0)[0].shape[0]


def _sweeps(gen, x, n_sweeps, thin, step_fn):
    """``n_sweeps`` sweeps of ``thin`` kernel steps each; returns the final
    state, the states after each sweep and the accumulated acceptance
    (the sum over sweeps of the sweep's mean over its steps and chains)."""
    state = (x,) + step_fn.init(x)
    acc, kept = 0.0, []
    for _ in range(n_sweeps):
        a = 0.0
        for _ in range(thin):
            state, accepted = step_fn(gen, state)
            a = a + accepted.to(_value_dtype(state[0])).mean()
        acc = acc + a / thin
        kept.append(state[0])
    return state[0], kept, acc


class _Stepper:
    """A per-chain kernel step over ``(x, log_prob, grad)`` carries."""

    def __init__(self, core, vg, **kw):
        self.core, self.vg, self.kw = core, vg, kw

    def init(self, x):
        return self.vg(x)

    def __call__(self, gen, state):
        x, lp, g = state
        draws = randn_like(gen, x)
        u = _uniform(gen, lp)
        x, acc, lp, g = self.core(x, draws, u, self.vg, log_prob_x=lp,
                                  grad_x=g, **self.kw)
        return (x, lp, g), acc


@torch.no_grad()
def run_hmc(gen: torch.Generator, x0, log_prob: Callable, *, n_samples: int,
            n_warmup: int = 0, step_size=0.1, n_leapfrog: int = 10,
            thin: int = 1) -> HMCResult:
    """HMC chains from ``x0 [C, ...]`` on the batched density ``log_prob``:
    ``n_warmup`` discarded sweeps, then ``n_samples`` kept sweeps, each of
    ``thin`` kernel steps. The current state's density and gradient ride
    along, so a step costs ``n_leapfrog`` value-and-grads. ``accept_rate``
    is the mean acceptance over the kept sweeps."""
    step = _Stepper(hmc_step, batched_value_and_grad(log_prob),
                    step_size=step_size, n_leapfrog=n_leapfrog)
    return _run(gen, x0, step, n_samples, n_warmup, thin)


@torch.no_grad()
def run_mala(gen: torch.Generator, x0, log_prob: Callable, *, n_samples: int,
             n_warmup: int = 0, step_size=0.01, thin: int = 1) -> HMCResult:
    """MALA chains, with :func:`run_hmc`'s contract and result."""
    step = _Stepper(mala_step, batched_value_and_grad(log_prob),
                    step_size=step_size)
    return _run(gen, x0, step, n_samples, n_warmup, thin)


def _run(gen, x0, step, n_samples, n_warmup, thin):
    if n_warmup:
        x0, _, _ = _sweeps(gen, x0, n_warmup, thin, step)
    xf, kept, acc = _sweeps(gen, x0, n_samples, thin, step)
    return HMCResult(samples=_stack(kept), final_state=xf,
                     accept_rate=acc / n_samples)


@torch.no_grad()
def dual_averaging_warmup(gen: torch.Generator, x0, log_prob: Callable, *,
                          n_adapt: int = 100, n_leapfrog: int = 10,
                          target_accept: float = 0.65,
                          init_step_size: float = 0.1):
    """Nesterov dual-averaging step-size adaptation (Hoffman & Gelman
    2014), ``n_adapt`` HMC steps with one step size shared by all chains
    (their mean acceptance): mu = log(10 eps0), gamma 0.05, t0 10, kappa
    0.75. Returns ``(adapted step size, x)``; the step size stays a tensor
    on the state's device (no host sync per step)."""
    dtype = _value_dtype(x0)
    dev = tree_leaves(x0)[0].device
    mu = math.log(10.0 * init_step_size)
    gamma, t0, kappa = 0.05, 10.0, 0.75
    log_eps = torch.full((), math.log(init_step_size), dtype=dtype,
                         device=dev)
    log_eps_bar, h_bar = log_eps.clone(), torch.zeros_like(log_eps)
    step = _Stepper(hmc_step, batched_value_and_grad(log_prob),
                    n_leapfrog=n_leapfrog)
    state = (x0,) + step.init(x0)
    for t in range(n_adapt):
        step.kw["step_size"] = torch.exp(log_eps)
        state, accepted = step(gen, state)
        a = accepted.to(dtype).mean()
        tt = t + 1.0
        h_bar = (1.0 - 1.0 / (tt + t0)) * h_bar + (target_accept - a) / (tt
                                                                        + t0)
        log_eps = mu - math.sqrt(tt) / gamma * h_bar
        w = tt ** (-kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return torch.exp(log_eps_bar), state[0]
