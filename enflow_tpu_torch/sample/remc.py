"""Replica-exchange Monte Carlo (parallel tempering), the port of
``enflow_tpu/sample/remc.py``: ``remc``, its chunked form
``remc_segments``, ``tile_replicas`` and the even/odd swap phase.

K temperature slots x M chains run tempered-HMC sweeps, then adjacent
slots propose configuration swaps in the deterministic even/odd pattern.
The family is SMC's bridge, ``pi_beta = (1-beta) log_q0 + beta log_p``
(``log_q0`` omitted: ``beta log_p``). Replicas live on a ``[K, M, ...]``
leading axis; every sweep runs all of them through ONE flattened ``[K*M]``
call of the batched tempered kernel with per-replica ``beta`` and
``step_size`` vectors (the JAX package's ``batched=True`` path), so on the
card each EGCL of the flow is one kernel launch over the whole ladder.
The component caches (values and gradients of both densities) travel with
the configurations through sweeps AND swaps, so a round costs exactly
``mcmc_steps * n_leapfrog`` value-and-grads of each density.

Swap acceptance for adjacent slots (k, k+1):
``log a = (beta_{k+1} - beta_k) * (e_k - e_{k+1})``, ``e = log_p - log_q0``.

Round ``r`` draws from a generator made from the ``r``-th of ``n_rounds``
seeds drawn up front (its sweeps' momenta and uniforms, then the swap
uniforms), so a chunked run equals the monolithic one bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .mcmc import (batched_value_and_grad, tempered_hmc_kernel_batched,
                   tree_leaves, tree_map)
from .smc import _generator, _stage_seeds


class REMCResult(NamedTuple):
    samples: Any          # [n_rounds, M, ...] draws of the beta=1 slot
    x_final: Any          # [K, M, ...] final replica states
    swap_accept: Any      # [K-1] mean swap acceptance per adjacent pair
    accept: Any           # [K] mean HMC acceptance per temperature slot
    betas: Any            # [K] the ladder, as used
    # [n_rounds] the caller's stage_fn a round (None without one)
    round_metric_history: Any = None


def tile_replicas(x, K: int):
    """Broadcast an ``[M, ...]`` chain state to ``[K, M, ...]`` replicas."""
    return tree_map(lambda a: a[None].expand((K,) + a.shape).clone(), x)


def _zero_log_q0(x):
    """The bridge density of a plain temperature ladder: zeros ``[n]``
    (written on ``x`` so that its gradient is a zero tensor)."""
    leaf = tree_leaves(x)[0]
    return 0.0 * leaf.reshape(leaf.shape[0], -1).sum(-1)


def _flatten_km(t, K, M):
    return tree_map(lambda a: a.reshape((K * M,) + a.shape[2:]), t)


def _unflatten_km(t, K, M):
    return tree_map(lambda a: a.reshape((K, M) + a.shape[1:]), t)


def _init_remc_caches(log_q0, log_p, x0):
    """``(x0, lq0, lp, glq0, glp)``: the component caches ``[K, M, ...]``
    at the initial states, through the flattened ``[K*M]`` densities."""
    K, M = tree_leaves(x0)[0].shape[:2]
    flat = _flatten_km(x0, K, M)
    lq0, glq0 = batched_value_and_grad(log_q0)(flat)
    lp, glp = batched_value_and_grad(log_p)(flat)
    return (x0, lq0.reshape(K, M), lp.reshape(K, M),
            _unflatten_km(glq0, K, M), _unflatten_km(glp, K, M))


def swap_phase(parity: int, uniform, state, betas):
    """The even/odd deterministic pairing with its uniforms given
    (``uniform [K-1, M]``): slot k proposes a swap with k+1 for k =
    parity, parity+2, ...; an accepted swap permutes the states AND their
    caches. Returns ``(state', rate [K-1], pair_on [K-1])``; a pair's rate
    is its mean acceptance over the chains in a round where it is on, 0
    otherwise."""
    x, lq0, lp, glq0, glp = state
    K, M = lq0.shape
    e = lp - lq0
    d_beta = betas[1:] - betas[:-1]
    log_a = d_beta[:, None] * (e[:-1] - e[1:])
    ks = torch.arange(K, device=lq0.device)
    pair_on = (ks[:-1] % 2) == parity
    acc = (torch.log(uniform) < log_a) & pair_on[:, None]
    none = torch.zeros((1, M), dtype=torch.bool, device=lq0.device)
    up = torch.cat([acc, none])
    down = torch.cat([none, acc])
    idx = ks[:, None] + up.to(torch.int64) - down.to(torch.int64)

    def perm(a):
        ix = idx.reshape(idx.shape + (1,) * (a.ndim - 2))
        return torch.take_along_dim(a, ix.expand(a.shape), dim=0)

    x, glq0, glp = (tree_map(perm, t) for t in (x, glq0, glp))
    rate = torch.where(pair_on[:, None], acc.to(lq0.dtype),
                       torch.zeros((), dtype=lq0.dtype,
                                   device=lq0.device)).mean(dim=1)
    return (x, perm(lq0), perm(lp), glq0, glp), rate, pair_on


def _make_one_round(log_q0, log_p, betas, step_size, mcmc_steps,
                    n_leapfrog, stage_fn=None):
    """One round ``(state, r, gen) -> (state, (target_slot, acc, rate,
    pair_on[, metric]))``: ``mcmc_steps`` tempered-HMC sweeps of the whole
    ladder in one flattened call each, then the swap phase of parity ``r %
    2``; with ``stage_fn``, its value on the flattened ``[K*M]`` replicas
    after the swaps (a device tensor)."""
    K = betas.shape[0]
    vgq = batched_value_and_grad(log_q0)
    vgp = batched_value_and_grad(log_p)

    def one_round(state, r, gen):
        x, lq0, lp, glq0, glp = state
        M = lq0.shape[1]
        beta_v = betas.repeat_interleave(M)
        ss_v = step_size.repeat_interleave(M)
        acc = torch.zeros((K,), dtype=lq0.dtype, device=lq0.device)
        for _ in range(mcmc_steps):
            fl = lambda t: _flatten_km(t, K, M)
            x2, a, vals, grads = tempered_hmc_kernel_batched(
                gen, fl(x), vgq, vgp, beta_v, ss_v, n_leapfrog,
                (lq0.reshape(K * M), lp.reshape(K * M)),
                (fl(glq0), fl(glp)))
            un = lambda t: _unflatten_km(t, K, M)
            x, glq0, glp = un(x2), un(grads[0]), un(grads[1])
            lq0, lp = vals[0].reshape(K, M), vals[1].reshape(K, M)
            acc = acc + a.reshape(K, M).to(acc.dtype).mean(dim=1)
        u = torch.rand((K - 1, M), generator=gen, dtype=lq0.dtype,
                       device=lq0.device)
        state, rate, pair_on = swap_phase(r % 2, u, (x, lq0, lp, glq0, glp),
                                          betas)
        target_slot = tree_map(lambda a: a[-1], state[0])
        out = (target_slot, acc / mcmc_steps, rate, pair_on)
        if stage_fn is not None:
            out = out + (stage_fn(_flatten_km(state[0], K, M)),)
        return state, out

    return one_round


def _aggregate(x, outs, betas) -> REMCResult:
    samples, accs, rates, pair_ons, *metrics = outs
    n_on = torch.clamp(pair_ons.to(torch.int64).sum(dim=0), min=1)
    return REMCResult(samples=samples, x_final=x,
                      swap_accept=rates.sum(dim=0) / n_on,
                      accept=accs.mean(dim=0), betas=betas,
                      round_metric_history=metrics[0] if metrics else None)


def _ladder(betas, step_size, like):
    betas = torch.as_tensor(betas, dtype=like.dtype, device=like.device)
    step = torch.as_tensor(step_size, dtype=like.dtype, device=like.device)
    return betas, torch.broadcast_to(step, betas.shape).clone()


def remc(gen: torch.Generator, x0, *, log_p: Callable,
         log_q0: Callable | None = None, betas, n_rounds: int,
         mcmc_steps: int = 1, step_size=0.05,
         n_leapfrog: int = 5, stage_fn=None) -> REMCResult:
    """Parallel tempering from ``betas[0]`` (hottest) to ``betas[-1] ==
    1`` over batched densities (``[n, ...] -> [n]``).

    ``x0 [K, M, ...]``: prefer independent draws per slot over
    :func:`tile_replicas` (swaps act within a chain column). ``step_size``
    is a scalar or a ``[K]`` per-slot step. ``samples`` stacks the
    ``beta = 1`` slot after every round (``[n_rounds, M, ...]``).
    ``stage_fn`` (optional): ``flattened [K*M, ...] replicas -> scalar``
    once a round, stacked into ``round_metric_history``. It is
    :func:`remc_segments` with one segment."""
    return remc_segments(gen, x0, log_p=log_p, log_q0=log_q0, betas=betas,
                         n_rounds=n_rounds, mcmc_steps=mcmc_steps,
                         step_size=step_size, n_leapfrog=n_leapfrog,
                         stage_fn=stage_fn, chunk_rounds=0)


@torch.no_grad()
def remc_segments(gen: torch.Generator, x0, *, log_p: Callable,
                  log_q0: Callable | None = None, betas, n_rounds: int,
                  mcmc_steps: int = 1, step_size=0.05, n_leapfrog: int = 5,
                  stage_fn=None,
                  chunk_rounds: int = 8, run_segment=None, on_segment=None,
                  start_round: int = 0, init_state=None,
                  init_outs=None) -> REMCResult:
    """:func:`remc` as segments of at most ``chunk_rounds`` rounds (``<=
    0``: one segment), the replica carry ``(x, lq0, lp, glq0, glp)`` held
    between them, equal to the monolithic run bit for bit.

    ``run_segment(fn, *args)`` wraps the cache fill and every segment (the
    driver's retry hook); ``on_segment(next_round, state, outs)`` fires
    after each segment; ``start_round`` / ``init_state`` / ``init_outs``
    resume from what it saw (``x0`` may be None then)."""
    if log_q0 is None:
        log_q0 = _zero_log_q0
    like = (init_state[1] if init_state is not None
            else tree_leaves(x0)[0])
    betas, step_size = _ladder(betas, step_size, like)
    seeds = _stage_seeds(gen, n_rounds)
    if chunk_rounds <= 0:
        chunk_rounds = n_rounds
    run = run_segment or (lambda f, *a: f(*a))
    one_round = _make_one_round(log_q0, log_p, betas, step_size,
                                mcmc_steps, n_leapfrog, stage_fn)
    device = like.device

    def seg_fn(state, r0, r1):
        outs = []
        for r in range(r0, r1):
            state, out = one_round(state, r, _generator(seeds[r], device))
            outs.append(out)
        return state, tuple(tree_map(lambda *a: torch.stack(a), *col)
                            for col in zip(*outs))

    state = (run(_init_remc_caches, log_q0, log_p, x0)
             if init_state is None else init_state)
    outs = list(init_outs) if init_outs else []
    r = int(start_round)
    while r < n_rounds:
        r2 = min(r + chunk_rounds, n_rounds)
        state, out = run(seg_fn, state, r, r2)
        outs.append(out)
        if on_segment is not None:
            on_segment(r2, state, outs)
        r = r2
    cat = tuple(tree_map(lambda *a: torch.cat(a), *(o[k] for o in outs))
                for k in range(5 if stage_fn is not None else 4))
    return _aggregate(state[0], cat, betas)
