"""Multi-device dry run, the port of ``__graft_entry__.py``'s
``dryrun_multichip``: every sharded program family of the port at tiny
shapes on an ``n``-device in-process mesh (``parallel/mesh.py``), each
checked finite and timed. Run ``python -m enflow_tpu_torch.parallel.dryrun
[N] [--device cpu]`` (default 4 virtual devices on the card).

- a data-parallel NLL train step (forward, backward, the gradient sum over
  the mesh, Adam);
- chain-sharded SMC and REMC on an LJ cluster;
- the ring pair energy against the dense one;
- a 2-D (data x atom) NLL train step through the ring flow and ring NLL;
- 2-D (chain x atom) SMC and REMC on a padded LJ cluster, SMC through the
  coupled flow and on the periodic LJ fluid, and thermodynamic
  integration.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..data.system import System
from ..flow.integrators import FlowConfig, forward, init_flow
from ..flow.loss import alchemical_nll
from ..flow.sharded import make_sharded_nll
from ..nn.egcl import EGCLConfig
from ..sample import smc, targets
from ..sample.remc import remc
from ..sample.sharded import make_sample_fns
from ..sample.ti import thermodynamic_integration
from ..sim.potentials import softened_lj_energy
from ..train.optim import NLLOptimizer
from ..utils.jax_params import tree_flatten
from .mesh import get_mesh, replicate, shard_batch, sum_grads
from .pairwise import make_sharded_lj_energy

NF = 5
F32 = torch.float32


def _batch(B, N, device, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=F32, device=device)
    return System(h=t(np.eye(NF)[rng.integers(0, NF, (B, N))]),
                  g=t(rng.normal(size=(B, N, NF)) * 0.3),
                  pos=t(rng.uniform(-2.5, 2.5, (B, N, 3))),
                  vel=t(rng.normal(size=(B, N, 3)) * 0.3),
                  mask=torch.ones((B, N), dtype=torch.bool, device=device),
                  box=t(np.full((B, 3), 5.0)), r_cut=t(np.full((B,), 3.0)))


def _latents(gen, n, n_atoms, device):
    kw = dict(generator=gen, dtype=F32, device=device)
    return {"h": torch.randn((n, n_atoms, NF), **kw),
            "g": torch.randn((n, n_atoms, NF), **kw),
            "pos": torch.randn((n, n_atoms, 3), **kw),
            "vel": torch.randn((n, n_atoms, 3), **kw)}


def _timed(fn, device, reps=3):
    """``(result, median seconds)`` of ``fn()`` over ``reps`` runs after a
    warm-up run."""
    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


def _train_step(params, opt, loss_fn):
    opt.zero_grad()
    loss = loss_fn(params)
    loss.backward()
    sum_grads(opt.leaves)
    opt.step()
    return loss.detach()


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun: {msg}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    device = resolve_device(device)
    n = int(n_devices)
    cfg = FlowConfig(n_iter=2, dt=0.05, egcl=EGCLConfig(NF, 16))
    params = init_flow(torch.Generator().manual_seed(0), cfg, F32, device)
    leaves, _ = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = NLLOptimizer(leaves, 1e-3)

    # ---- data-parallel train step: rows over 'data', params replicated
    mesh = get_mesh(("data",), virtual_devices=n)
    batch = shard_batch(_batch(2 * n, 6, device), mesh)
    replicate(params, mesh)
    gen = torch.Generator(device=device).manual_seed(2)

    def dp_loss(p):
        out, ldj = forward(p, cfg, batch, gen=gen)
        return alchemical_nll(out, ldj, 0.62, 0.1, data_axis=mesh["data"])

    loss, t_dp = _timed(lambda: _train_step(params, opt, dp_loss), device)
    _require(bool(torch.isfinite(loss)), "data-parallel train step NaN")
    print(f"[dryrun] DP train step: {t_dp * 1e3:.1f} ms/step; "
          f"{2 * n} molecules over {n} devices", flush=True)

    # ---- chain-sharded SMC and REMC (the chain axis holds every particle)
    t6 = targets.lj_cluster(6, kBT=2.0)
    g = torch.Generator(device=device).manual_seed(3)
    x0 = 1.2 * torch.randn((4 * n, 6, 3), generator=g, dtype=F32,
                           device=device)

    def log_q0(x):
        return -0.5 * (x ** 2).sum(dim=(1, 2)) / 1.44

    run = lambda: smc(torch.Generator(device=device).manual_seed(4), x0,
                      log_q0=log_q0, log_p=t6.log_prob, n_temps=3,
                      mcmc_steps=1, step_size=0.02, n_leapfrog=2)
    res, t_smc = _timed(run, device)
    _require(bool(torch.isfinite(res.log_Z)), "chain-sharded SMC NaN")
    print(f"[dryrun] chain-sharded SMC: {t_smc * 1e3:.1f} ms/anneal; "
          f"{4 * n} chains", flush=True)
    betas = torch.tensor([0.2, 0.6, 1.0], dtype=F32, device=device)
    x0r = x0[None] * torch.linspace(0.9, 1.1, 3, dtype=F32,
                                    device=device)[:, None, None, None]
    res_r = remc(torch.Generator(device=device).manual_seed(7), x0r,
                 log_p=t6.log_prob, log_q0=log_q0, betas=betas, n_rounds=2,
                 mcmc_steps=1, step_size=0.02, n_leapfrog=2)
    _require(bool(torch.isfinite(res_r.swap_accept).all()),
             "chain-sharded REMC NaN")
    print(f"[dryrun] chain-sharded REMC: 2 rounds x 3 temps OK; swap_accept "
          f"{[round(float(a), 2) for a in res_r.swap_accept]}", flush=True)

    # ---- the ring pair energy against the dense one
    atom_mesh = get_mesh(("atom",), virtual_devices=n)
    n_at = 8 * n
    pos = (torch.rand((n_at, 3), generator=torch.Generator().manual_seed(5),
                      dtype=F32) * 6.0 - 3.0).to(device)
    am = torch.ones((n_at,), dtype=torch.bool, device=device)
    box = torch.full((3,), 6.0, dtype=F32, device=device)
    e_s = make_sharded_lj_energy(atom_mesh)(pos, am, box, 0.1, 3.0)
    e_d = softened_lj_energy(pos, box, 0.1, 3.0, am)
    _require(bool(torch.isclose(e_s, e_d, rtol=1e-5)),
             f"ring pair energy {float(e_s)} != dense {float(e_d)}")
    print(f"[dryrun] ring pair energy over {n} shards: {float(e_s):.4f} "
          f"(dense {float(e_d):.4f})", flush=True)

    # ---- 2-D (data x atom) train step: ring flow and ring NLL
    atom_ax = 2 if n % 2 == 0 else n
    n_data = n // atom_ax
    mesh2d = get_mesh(("data", "atom"), (n_data, atom_ax), virtual_devices=n)
    batch2 = _batch(2 * n_data, 2 * atom_ax, device, seed=7)
    nll = make_sharded_nll(mesh2d, cfg, 0.62, 0.1, data_axis="data")
    gen2 = torch.Generator(device=device).manual_seed(6)
    loss2, t_2d = _timed(lambda: _train_step(
        params, opt, lambda p: nll(p, batch2, gen=gen2)), device)
    _require(bool(torch.isfinite(loss2)), "atom-sharded train step NaN")
    print(f"[dryrun] 2-D (data x atom) train step: {t_2d * 1e3:.1f} ms/step; "
          f"{2 * atom_ax} atoms over {atom_ax} shards", flush=True)

    # ---- 2-D (chain x atom) sampling through the sharded densities
    cfg_sp = dataclasses.replace(cfg, nbr_mode="all_pairs")
    n_at_s = 2 * atom_ax + 1            # odd: exercises the atom padding
    Ps = 4 * n_data
    t_s = targets.lj_cluster(n_at_s, kBT=2.0, softening=0.1, e_cap=1e3)

    def sample_2d(prm, c, target, box_len, r_cut, seed, label):
        prop, q0, lp, n_pad = make_sample_fns(prm, c, target, n_at_s,
                                              box_len, r_cut, mesh=mesh2d)
        g = torch.Generator(device=device).manual_seed(seed)
        run = lambda: smc(g, prop(_latents(g, Ps, n_pad, device)),
                          log_q0=q0, log_p=lp, n_temps=2, mcmc_steps=1,
                          step_size=0.02, n_leapfrog=2)
        res, secs = _timed(run, device, reps=1)
        _require(bool(torch.isfinite(res.log_Z)), f"2-D SMC{label} NaN")
        print(f"[dryrun] 2-D (chain x atom) SMC{label}: {secs * 1e3:.1f} "
              f"ms/anneal; P={Ps} chains x {n_at_s}->{n_pad} atoms on "
              f"({n_data} x {atom_ax}) mesh, log_Z {float(res.log_Z):.2f}",
              flush=True)
        return prop, q0, lp, n_pad

    prop_s, q0_s, p_s, n_pad = sample_2d(params, cfg_sp, t_s, 1e3, 1e2, 8,
                                         "")
    g = torch.Generator(device=device).manual_seed(9)
    Kr, Mr = 3, 2 * n_data
    x0r = {k: v.reshape((Kr, Mr) + v.shape[1:])
           for k, v in prop_s(_latents(g, Kr * Mr, n_pad, device)).items()}
    res_r2 = remc(g, x0r, log_p=p_s, log_q0=q0_s,
                  betas=torch.tensor([0.0, 0.5, 1.0], dtype=F32,
                                     device=device),
                  n_rounds=2, mcmc_steps=1, step_size=0.02, n_leapfrog=2)
    _require(bool(torch.isfinite(res_r2.swap_accept).all()), "2-D REMC NaN")
    print(f"[dryrun] 2-D (chain x atom) REMC: {Kr} temps x {Mr} chains OK",
          flush=True)

    cfg_cp = dataclasses.replace(cfg_sp, position_update="coupled",
                                 exact_ldj=True)
    params_cp = init_flow(torch.Generator().manual_seed(12), cfg_cp, F32,
                          device)
    sample_2d(params_cp, cfg_cp, t_s, 1e3, 1e2, 13, ", coupled flow")
    t_f = targets.lj_fluid(n_at_s, box=2.5, kBT=2.0, softening=0.1,
                           cutoff=1.2, e_cap=500.0)
    sample_2d(params, cfg_sp, t_f, 2.5, 1.2, 14, ", lj_fluid target")

    g = torch.Generator(device=device).manual_seed(15)
    res_ti = thermodynamic_integration(
        g, prop_s(_latents(g, Ps, n_pad, device)), log_q0=q0_s, log_p=p_s,
        n_nodes=3, n_steps=6, n_warmup=2, step_size=0.05, n_leapfrog=2,
        adapt_step=True, chunk_steps=4)
    _require(bool(np.isfinite(float(res_ti.log_Z))), "2-D TI NaN")
    print(f"[dryrun] 2-D (chain x atom) TI: 3 nodes OK "
          f"(log_Z {float(res_ti.log_Z):.2f})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m enflow_tpu_torch.parallel."
                                 "dryrun", description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=4,
                    help="virtual devices (default 4)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip({args.n}) OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
