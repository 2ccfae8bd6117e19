"""No-U-Turn Sampler (iterative, multinomial), the port of
``enflow_tpu/sample/nuts.py``.

Multinomial NUTS (Hoffman & Gelman 2014; Betancourt 2017) with the
iterative tree building of the JAX module: a doubling tree of depth up to
``max_depth``, explored one leapfrog at a time, with an O(max_depth)
checkpoint stack for the sub-tree U-turn checks. A leaf ``j`` with
``to(j)`` trailing one bits ends sub-trees of sizes 2..2^to(j) whose start
leaves are the top ``to(j)`` checkpoints; after their generalized U-turn
checks the top ``to(j) - 1`` are popped.

The JAX kernel is a ``while_loop`` vmapped over chains: each chain's tree
stops at its own depth while the loop runs on until every chain has
stopped. Here all chains run as one batch (flat states ``[C, D]``, a
batched density) and per-chain masks keep that semantics: a chain that has
turned or diverged takes no further effect, and a loop ends when no chain
is left running in it. Every chain that is running is at the same depth
and leaf index, so the stack pointer and the trailing-ones counts are
plain integers. The gradients at the tree's two edges are carried, so a
leaf costs one batched value-and-grad. ``H = -log_prob + |p|^2 / 2``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .mcmc import batched_value_and_grad

DIVERGENCE_THRESHOLD = 1000.0


def _leapfrog(glp, q, p, eps, g):
    """One leapfrog step with the incoming force ``g = glp(q)`` cached."""
    p = p + 0.5 * eps * g
    q = q + eps * p
    g = glp(q)
    p = p + 0.5 * eps * g
    return q, p, g


def _dot(a, b):
    return (a * b).sum(-1)


def _uturn(p_sum, p_first, p_last):
    return (_dot(p_sum, p_first) < 0.0) | (_dot(p_sum, p_last) < 0.0)


def _count_trailing_zeros(m: int) -> int:
    """Trailing zero bits of ``m`` over 31 bits (31 for 0, as the JAX
    helper's loop gives)."""
    tz = 0
    for i in range(31):
        if (m >> i) & 1:
            break
        tz += 1
    return tz


def _count_trailing_ones(n: int) -> int:
    """Trailing one bits of ``n >= 0``: the trailing zeros of ``n + 1``."""
    return _count_trailing_zeros(n + 1)


class _Tree(NamedTuple):
    q_left: torch.Tensor
    p_left: torch.Tensor
    g_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    g_right: torch.Tensor
    q_prop: torch.Tensor      # current multinomial proposal
    log_w: torch.Tensor       # logsumexp of -dH over the tree
    p_sum: torch.Tensor       # momentum sum over the tree
    turning: torch.Tensor
    diverging: torch.Tensor


def _where(mask, a, b):
    """Per-chain select of two trees (or tensors) on ``mask [C]``."""
    if isinstance(a, _Tree):
        return _Tree(*(_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _build_subtree(gen, vg, q0, p0, g0, h0, eps, direction, depth: int,
                   max_depth: int, active):
    """A sub-tree of ``2**depth`` leaves from the edge ``(q0, p0, g0)`` for
    the chains in ``active [C]``, each stopping at its own divergence or
    sub-tree U-turn. Left is the first state simulated, right the last;
    momenta are kept in the global rightward convention."""
    C, D = q0.shape
    dt = q0.dtype
    false = torch.zeros((C,), dtype=torch.bool, device=q0.device)
    tree = _Tree(q0, p0, g0, q0, p0, g0, q0,
                 torch.full((C,), -float("inf"), dtype=dt, device=q0.device),
                 torch.zeros_like(p0), false, false)
    dirc = direction[:, None]
    q, p_sim, g = q0, dirc * p0, g0
    p_ckpt = torch.zeros((C, max_depth + 1, D), dtype=dt, device=q0.device)
    psum_ckpt = torch.zeros_like(p_ckpt)
    sp = 0
    for i in range(2 ** depth):
        run = active & ~tree.turning & ~tree.diverging
        if not bool(run.any()):
            break
        lp = {}

        def glp(x):
            lp["v"], grad = vg(x)
            return grad

        q_n, p_sim_n, g_n = _leapfrog(glp, q, p_sim, eps, g)
        p = dirc * p_sim_n
        dh = -lp["v"] + 0.5 * _dot(p, p) - h0
        diverging = dh > DIVERGENCE_THRESHOLD
        log_w_leaf = -dh
        p_sum = tree.p_sum + p
        # progressive multinomial proposal within the sub-tree
        log_w_new = torch.logaddexp(tree.log_w, log_w_leaf)
        take = torch.rand((C,), generator=gen, dtype=dt, device=q0.device) \
            < torch.exp(log_w_leaf - log_w_new)
        q_prop = _where(take, q_n, tree.q_prop)
        turning = tree.turning
        if i % 2 == 0:
            # an even leaf starts sub-trees: its momentum and the momentum
            # sum BEFORE it
            p_ckpt[:, sp] = p
            psum_ckpt[:, sp] = tree.p_sum
            sp += 1
        else:
            # an odd leaf ends the sub-trees of its to(i) checkpoints
            t_ones = _count_trailing_ones(i)
            for k in range(1, t_ones + 1):
                rho = p_sum - psum_ckpt[:, sp - k]
                turning = turning | _uturn(rho, p_ckpt[:, sp - k], p)
            sp -= t_ones - 1
        first = i == 0
        new = _Tree(q_n if first else tree.q_left,
                    p if first else tree.p_left,
                    g_n if first else tree.g_left,
                    q_n, p, g_n, q_prop, log_w_new, p_sum, turning,
                    tree.diverging | diverging)
        tree = _where(run, new, tree)
        q, p_sim, g = (_where(run, a, b) for a, b in
                       ((q_n, q), (p_sim_n, p_sim), (g_n, g)))
    return tree


def nuts_step(gen: torch.Generator, q, vg: Callable, step_size,
              max_depth: int = 8):
    """One NUTS transition for every chain of the flat states ``q [C, D]``
    on the batched value-and-grad ``vg``. Returns ``(q', info)`` with the
    per-chain ``depth`` reached and ``diverging``."""
    C = q.shape[0]
    dev, dt = q.device, q.dtype
    p0 = torch.randn(q.shape, generator=gen, dtype=dt, device=dev)
    lp0, g0 = vg(q)
    h0 = -lp0 + 0.5 * _dot(p0, p0)
    false = torch.zeros((C,), dtype=torch.bool, device=dev)
    tree = _Tree(q, p0, g0, q, p0, g0, q, torch.zeros((C,), dtype=dt,
                                                        device=dev),
                 p0, false, false)
    depth = torch.zeros((C,), dtype=torch.int64, device=dev)
    for j in range(max_depth):
        active = ~tree.turning & ~tree.diverging
        if not bool(active.any()):
            break
        go_right = torch.rand((C,), generator=gen, dtype=dt, device=dev) < 0.5
        direction = torch.where(go_right, 1.0, -1.0).to(dt)
        edge = [_where(go_right, r, l) for l, r in
                ((tree.q_left, tree.q_right), (tree.p_left, tree.p_right),
                 (tree.g_left, tree.g_right))]
        sub = _build_subtree(gen, vg, *edge, h0, step_size, direction, j,
                             max_depth, active)
        # biased progressive sampling between the old tree and the new one
        accept_prob = torch.clamp(torch.exp(sub.log_w - tree.log_w), max=1.0)
        take = (torch.rand((C,), generator=gen, dtype=dt, device=dev)
                < accept_prob) & ~sub.turning & ~sub.diverging
        q_prop = _where(take, sub.q_prop, tree.q_prop)
        left = [_where(go_right, a, b) for a, b in
                ((tree.q_left, sub.q_right), (tree.p_left, sub.p_right),
                 (tree.g_left, sub.g_right))]
        right = [_where(go_right, a, b) for a, b in
                 ((sub.q_right, tree.q_right), (sub.p_right, tree.p_right),
                  (sub.g_right, tree.g_right))]
        p_sum = tree.p_sum + sub.p_sum
        turning = sub.turning | sub.diverging | _uturn(p_sum, left[1],
                                                       right[1])
        merged = _Tree(*left, *right, q_prop,
                       torch.logaddexp(tree.log_w, sub.log_w), p_sum,
                       turning, tree.diverging | sub.diverging)
        tree = _where(active, merged, tree)
        depth = depth + active.to(depth.dtype)
    return tree.q_prop, {"depth": depth, "diverging": tree.diverging}


def nuts_kernel(gen: torch.Generator, q, log_prob: Callable, step_size,
                max_depth: int = 8):
    """One NUTS transition over flat states ``q [C, D]`` on the batched
    density ``log_prob``."""
    return nuts_step(gen, q, batched_value_and_grad(log_prob), step_size,
                     max_depth)


class NUTSResult(NamedTuple):
    samples: torch.Tensor         # [n_samples, C, D]
    final_state: torch.Tensor     # [C, D]
    mean_depth: torch.Tensor
    divergence_rate: torch.Tensor


@torch.no_grad()
def run_nuts(gen: torch.Generator, x0, log_prob: Callable, *, n_samples: int,
             n_warmup: int = 0, step_size=0.1, max_depth: int = 8,
             target_accept: float = 0.8) -> NUTSResult:
    """NUTS chains over flat states ``x0 [C, D]``. Warmup runs NUTS with
    the JAX module's step control: the log step size falls by 0.3 after a
    transition whose divergence rate exceeds 0.05 and grows by 0.02
    otherwise; the kept transitions use the warmed-up step size.
    ``target_accept`` is accepted for the JAX signature; the control does
    not read it."""
    vg = batched_value_and_grad(log_prob)
    log_eps = torch.log(torch.as_tensor(step_size, dtype=x0.dtype,
                                        device=x0.device))
    x = x0
    for _ in range(n_warmup):
        x, info = nuts_step(gen, x, vg, torch.exp(log_eps), max_depth)
        div_rate = info["diverging"].to(x.dtype).mean()
        log_eps = log_eps + torch.where(div_rate > 0.05, -0.3, 0.02).to(
            x.dtype)
    eps = torch.exp(log_eps)
    samples, depths, divs = [], [], []
    for _ in range(n_samples):
        x, info = nuts_step(gen, x, vg, eps, max_depth)
        samples.append(x)
        depths.append(info["depth"])
        divs.append(info["diverging"])
    return NUTSResult(samples=torch.stack(samples), final_state=x,
                      mean_depth=torch.stack(depths).to(x.dtype).mean(),
                      divergence_rate=torch.stack(divs).to(x.dtype).mean())
