"""MBAR: multistate Bennett acceptance ratio, the port of
``enflow_tpu/sample/mbar.py``.

Pools configurations drawn from K thermodynamic states into estimates of
the relative free energies ``f_k = -log Z_k`` and per-state importance
weights (Shirts & Chodera 2008), by a fixed number of self-consistent
logsumexp iterations. Inputs are reduced potentials ``u_kn[k, n] = -log
q_k(x_n)`` of pooled sample ``n`` under state ``k``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mcmc import tree_map


class MBARResult(NamedTuple):
    f: torch.Tensor          # [K] relative free energies, f[0] = 0
    log_w: torch.Tensor      # [K, N] normalized log weights per state
    converged: torch.Tensor  # max |f change| on the last iteration


def mbar(u_kn, counts, n_iter: int = 200) -> MBARResult:
    """Solve the MBAR equations by ``n_iter`` self-consistent iterations,
    ``f`` re-anchored to ``f[0] = 0`` at each. ``u_kn [K, N]``, ``counts
    [K]`` samples drawn from each state (``counts.sum() == N``). Returns
    ``f[k] = -log(Z_k / Z_0)`` and ``log_w[k]`` with ``E_k[A] = sum_n
    exp(log_w[k, n]) A(x_n)``."""
    u_kn = torch.as_tensor(u_kn)
    counts = torch.as_tensor(counts, dtype=u_kn.dtype, device=u_kn.device)
    log_c = torch.log(counts)
    f = torch.zeros(u_kn.shape[0], dtype=u_kn.dtype, device=u_kn.device)
    delta = torch.zeros((), dtype=u_kn.dtype, device=u_kn.device)
    for _ in range(n_iter):
        # log denominator per sample: logsumexp_j [log N_j + f_j - u_jn]
        log_d = torch.logsumexp(log_c[:, None] + f[:, None] - u_kn, dim=0)
        f_new = -torch.logsumexp(-u_kn - log_d[None, :], dim=1)
        f_new = f_new - f_new[0]
        delta = (f_new - f).abs().max()
        f = f_new
    log_d = torch.logsumexp(log_c[:, None] + f[:, None] - u_kn, dim=0)
    log_w = -u_kn - log_d[None, :]
    log_w = log_w - torch.logsumexp(log_w, dim=1, keepdim=True)
    return MBARResult(f=f, log_w=log_w, converged=delta)


def bridge_potentials(betas, lq0, lp):
    """``u_kn = -[(1 - beta_k) log_q0 + beta_k log_p]`` of samples with
    the component values ``lq0``, ``lp [N]``: ``[K, N]``."""
    return -((1.0 - betas)[:, None] * lq0[None, :]
             + betas[:, None] * lp[None, :])


@torch.no_grad()
def mbar_from_remc(res, log_p, log_q0=None):
    """MBAR inputs from a ``remc.REMCResult``: every slot's final chains
    pooled (``[K*M]``) and evaluated under the bridged family at all K
    betas through the batched densities. Returns ``(u_kn [K, K*M], counts
    [K])``."""
    betas = res.betas
    K = betas.shape[0]
    pooled = tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), res.x_final)
    lp = log_p(pooled)
    lq0 = torch.zeros_like(lp) if log_q0 is None else log_q0(pooled)
    u_kn = bridge_potentials(betas, lq0, lp)
    M = lp.shape[0] // K
    return u_kn, torch.full((K,), M, dtype=u_kn.dtype, device=u_kn.device)


def mbar_block_log_z(u_kn, states, columns, K: int, n_blocks: int = 4,
                     n_iter: int = 200):
    """Block-replicate MBAR ``log_Z`` estimates over independent chain
    columns: the ``M`` columns split into ``n_blocks`` equal contiguous
    blocks (columns past ``M - M % n_blocks`` dropped), MBAR solved on each
    alone; returns the per-block ``-(f[-1] - f[0])`` (numpy). ``states``
    and ``columns`` ``[N]`` are each pooled sample's state and chain
    column."""
    u_kn = torch.as_tensor(u_kn)
    states = np.asarray(states)
    columns = np.asarray(columns)
    M = int(columns.max()) + 1
    n_blocks = max(1, min(int(n_blocks), M))
    width = M // n_blocks
    vals = []
    for b in range(n_blocks):
        sel = np.nonzero((columns >= b * width)
                         & (columns < (b + 1) * width))[0]
        counts_b = np.bincount(states[sel], minlength=K)
        r = mbar(u_kn[:, torch.as_tensor(sel, device=u_kn.device)],
                 torch.as_tensor(counts_b, dtype=u_kn.dtype,
                                 device=u_kn.device), n_iter=n_iter)
        vals.append(-float(r.f[-1] - r.f[0]))
    return np.asarray(vals)
