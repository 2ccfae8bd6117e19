"""Atom-sharded flow-proposal sampling, the port of
``enflow_tpu/sample/sharded.py``.

The samplers (``smc``, ``ais``, ``remc``, ``thermodynamic_integration``)
see whole particles ``[P, n_pad, ...]``; the densities split each
particle's atoms over the mesh's ``atom`` axis and run the ring EGCL flow
(``FlowConfig.axis_name``) and the target's ring pair terms
(``Target.log_prob_sharded``), O(N^2 / K) work a shard. The HMC gradients
run through the ring by autograd. In one process the chain axis holds
every particle; over processes the driver splits the densities' particles
over it (``parallel/mesh.py:split_rows``).

Atom counts that the atom axis does not divide are padded to ``n_pad``
with masked atoms: their latents are drawn and then zeroed, they stay out
of every density term (they random-walk under HMC, which cancels in the
acceptance since they feel no force), and callers trim ``[:, :n_atoms]``
before writing output. With ``mesh=None`` the same function returns the
dense batched densities of the same values, the oracle of the tests.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.system import System
from ..flow.integrators import FlowConfig, forward_core, reverse_core
from ..flow.sharded import _sharded_cfg, gather_system, shard_system


def _round_up(n, m):
    return -(-n // m) * m


def make_sample_fns(params, cfg: FlowConfig, target, n_atoms: int, box: float,
                    r_cut: float, mesh=None, atom_axis: str = "atom",
                    n_pad: int | None = None):
    """The batched densities of the sharded samplers: ``(propose, log_q0,
    log_p, n_pad)``.

    - ``propose(z)``: the flow pushforward (``reverse_core``, no graph) of
      latent draws ``z = {h, g, pos, vel}`` with leaves ``[n, n_pad, ...]``
      (the driver draws them as the dense path does, so the draws agree
      when ``n_pad == n_atoms``), their padded atoms zeroed first.
    - ``log_q0(x) -> [P]``: the flow-proposal density (exact ldj forced).
    - ``log_p(x) -> [P]``: the target plus the auxiliary Gaussians.

    ``n_pad`` forces the padded atom count (the dense oracle of a padded
    sharded run). A target without ``log_prob_sharded`` (the force field)
    raises ``NotImplementedError`` with a mesh."""
    cfg = dataclasses.replace(cfg, exact_ldj=True)
    if mesh is not None:
        ax = mesh[atom_axis]
        n_pad = n_pad or _round_up(n_atoms, ax.size)
        if n_pad % ax.size:
            raise ValueError(f"n_pad={n_pad} must divide over the "
                             f"{atom_axis} axis ({ax.size})")
        if target.log_prob_sharded is None:
            raise NotImplementedError(
                f"target {target.name!r} has no atom-sharded density "
                "(Target.log_prob_sharded) — atom-axis sampling supports "
                "lj_cluster / lj_fluid / double_well / gaussian targets")
        cfg_s = _sharded_cfg(cfg, ax)
    else:
        n_pad = n_pad or n_atoms

    def system(x):
        P, dev, dt = x["pos"].shape[0], x["pos"].device, x["pos"].dtype
        mask = (torch.arange(n_pad, device=dev) < n_atoms).expand(P, n_pad)
        return System(h=x["h"], g=x["g"], pos=x["pos"], vel=x["vel"],
                      mask=mask, box=torch.full((P, 3), box, dtype=dt,
                                                device=dev),
                      r_cut=torch.full((P,), r_cut, dtype=dt, device=dev))

    def gauss(fields, mask, psum):
        """``-1/2`` the sum of squares over real atoms, ``[B]``."""
        tot = 0.0
        for f in fields:
            tot = tot + torch.where(mask[..., None], f,
                                    torch.zeros_like(f)).pow(2).sum(
                                        dim=(1, 2))
        return -0.5 * psum(tot)

    if mesh is None:
        def log_q0(x):
            out, ldj = forward_core(params, cfg, system(x))
            return gauss((out.h, out.g, out.vel, out.pos), out.mask,
                         lambda t: t) + ldj

        def log_p(x):
            # the padded atoms sit beyond n_atoms: slice them off for the
            # dense per-configuration density
            s = system(x)
            return (target.log_prob(x["pos"][:, :n_atoms])
                    + gauss((s.h, s.g, s.vel), s.mask, lambda t: t))

        def run_reverse(s):
            return reverse_core(params, cfg, s)[0]
    else:
        def log_q0(x):
            out, ldj = forward_core(params, cfg_s,
                                    shard_system(system(x), mesh, atom_axis))
            return ax.collapse(gauss((out.h, out.g, out.vel, out.pos),
                                     out.mask, ax.psum) + ldj)

        def log_p(x):
            s = shard_system(system(x), mesh, atom_axis)
            lp = target.log_prob_sharded(s.pos, s.mask, ax)
            return ax.collapse(lp + gauss((s.h, s.g, s.vel), s.mask,
                                          ax.psum))

        def run_reverse(s):
            out, _ = reverse_core(params, cfg_s,
                                  shard_system(s, mesh, atom_axis))
            return gather_system(out, mesh, atom_axis)

    @torch.no_grad()
    def propose(z):
        if n_pad > n_atoms:
            real = (torch.arange(n_pad, device=z["pos"].device)
                    < n_atoms)[None, :, None]
            z = {k: torch.where(real, v, torch.zeros_like(v))
                 for k, v in z.items()}
        s = run_reverse(system(z))
        return {"h": s.h, "g": s.g, "pos": s.pos, "vel": s.vel}

    return propose, log_q0, log_p, n_pad
