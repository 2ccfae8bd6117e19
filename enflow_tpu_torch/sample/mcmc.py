"""Batched tempered HMC, the port of ``enflow_tpu/sample/mcmc.py``.

Particle states are a tensor ``[P, ...]`` or a dict of such tensors (the
JAX package's pytrees; dict leaves are visited in sorted key order, as JAX
flattens them). ``torch.Generator``s take the place of PRNG keys. Ported:
``batched_value_and_grad`` and the batched tempered-HMC kernel with its
optional diagonal ``mass``; the per-chain kernels, MALA and the HMC/NUTS
drivers are ROADMAP A5.
"""

from __future__ import annotations

from typing import Callable

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


def tempered_hmc_kernel_batched(gen: torch.Generator, x, vgq: Callable,
                                vgp: Callable, beta, step_size,
                                n_leapfrog: int, vals, grads, mass=None):
    """One HMC step over all particles targeting
    ``(1-beta) log_q0 + beta log_p``, reusing the cached component values
    ``vals = (lq0, lp)`` and gradients ``grads = (glq0, glp)`` at ``x``.

    Each call costs exactly ``n_leapfrog`` value-and-grads of each
    component. ``mass``: optional per-coordinate position scales ``s``
    (``M = diag(1/s^2)``), broadcast across particles. Returns
    ``(x', accepted [P], vals', grads')`` with the caches at the accepted
    state."""
    w0, w1 = 1.0 - beta, beta

    def comb(gq, gp):
        return tree_map(lambda a, b: _coef(w0, a) * a + _coef(w1, b) * b,
                        gq, gp)

    p0 = tree_map(lambda a: torch.randn(a.shape, generator=gen,
                                        dtype=a.dtype, device=a.device), x)
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
    u = torch.rand(lp0.shape, generator=gen, dtype=lp0.dtype,
                   device=lp0.device)
    accept = torch.log(u) < h0 - h1

    def sel(a, b):
        return tree_map(lambda s, t: torch.where(
            accept.reshape(accept.shape + (1,) * (s.ndim - 1)), s, t), a, b)

    x_out = sel(q, x)
    vals_out = (torch.where(accept, vq, vals[0]),
                torch.where(accept, vp, vals[1]))
    grads_out = (sel(gq, grads[0]), sel(gp, grads[1]))
    return x_out, accept, vals_out, grads_out
