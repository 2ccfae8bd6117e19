"""YAML-driven driver, the port of ``enflow_tpu/train/driver.py``.

Ported: ``mode: sample`` with ``sampling.algo: smc | ais`` (flow-proposal
SMC/AIS over an ``lj_cluster`` target), from a checkpoint's hparams or
from a fresh ``init_flow`` when the YAML gives ``dynamics.n_iter``, ``dt``,
``integrator`` and ``network``. The config schema, the npz output keys and
the one-line summary are the JAX driver's. Every other mode, algo, target
and option raises ``NotImplementedError`` naming its ROADMAP item.

The SMC runs batched: the densities see all particles at once, so on the
card each EGCL is one launch of the fused kernel over the particle batch.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import yaml

from .. import resolve_device
from ..data.system import System
from ..flow.integrators import (FlowConfig, init_flow, forward_core,
                                reverse_core)
from ..nn.egcl import EGCLConfig
from ..utils import conversion as cv
from .checkpoint import load_checkpoint, load_hparams

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, **kwargs)


def _gauss_aux(sys_b: System) -> torch.Tensor:
    """``-0.5 * |(h, g, vel)|^2`` per particle: ``[P]``."""
    tot = 0.0
    for f in (sys_b.h, sys_b.g, sys_b.vel):
        tot = tot + (f * f).sum(dim=tuple(range(1, f.ndim)))
    return -0.5 * tot


def flow_densities(params, cfg: FlowConfig, target, n_atoms: int,
                   box: float = 1e3, r_cut: float = 1e2):
    """The batched SMC densities over particle dicts ``{h, g, pos, vel}``:
    ``(propose_from_latents, log_q0, log_p)``.

    ``log_q0`` is the flow-pushforward density ``base(forward_core(x)) +
    ldj`` (``cfg.exact_ldj`` should be on: the parity ldj biases the
    weights), ``log_p`` the target plus the auxiliary Gaussians, and
    ``propose_from_latents(z)`` maps latent draws through ``reverse_core``
    without building a graph."""

    def to_system(x):
        P = x["h"].shape[0]
        dt, dev = x["pos"].dtype, x["pos"].device
        return System(h=x["h"], g=x["g"], pos=x["pos"], vel=x["vel"],
                      mask=torch.ones((P, n_atoms), dtype=torch.bool,
                                      device=dev),
                      box=torch.full((P, 3), box, dtype=dt, device=dev),
                      r_cut=torch.full((P,), r_cut, dtype=dt, device=dev))

    def log_q0(x):
        out, ldj = forward_core(params, cfg, to_system(x))
        return _gauss_aux(out) - 0.5 * (out.pos ** 2).sum(dim=(1, 2)) + ldj

    def log_p(x):
        return target.log_prob(x["pos"]) + _gauss_aux(to_system(x))

    @torch.no_grad()
    def propose_from_latents(z):
        s, _ = reverse_core(params, cfg, to_system(z))
        return {"h": s.h, "g": s.g, "pos": s.pos, "vel": s.vel}

    return propose_from_latents, log_q0, log_p


class Main:
    """Mode dispatcher. ``device`` is where the run happens: CUDA unless the
    caller passes ``"cpu"``; without a card it raises."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def setup(self, input_path):
        with open(input_path) as f:
            args = yaml.safe_load(f)
        self.args = args

        mode = args.get("mode", "train")
        if mode != "sample":
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet (ROADMAP queue A: train is "
                "items 5-6, generate item 7, dataset item 5); the port runs "
                "mode 'sample'")
        self.mode = mode
        if int(args.get("parallel", {}).get("atom_axis", 1)) > 1:
            raise NotImplementedError(
                "parallel.atom_axis > 1 is not ported yet (ROADMAP queue A "
                "item 9)")
        self.dtype = _DTYPES[args.get("precision", "float32")]
        self.seed = int(args.get("seed", 0))

        dyn = args.get("dynamics", {})
        self.checkpoint_path = dyn.get("checkpoint_path", "")
        hp = None
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            print("Loading from saved state", flush=True)
            hp = load_hparams(self.checkpoint_path)
            node_nf = hp["node_nf"]
            self.hidden_nf = hp["hidden_nf"]
            self.n_iter = hp["n_iter"]
            dt = hp["dt"]
            self.integrator = hp["integrator"]
            self.dequantizer = hp.get("dequantizer", "argmax")
            self.dequant_scale = float(hp.get("dequant_scale", 1.0))
        else:
            node_nf = int(dyn["network"]["node_nf"])
            self.hidden_nf = int(dyn["network"]["hidden_nf"])
            self.n_iter = int(dyn["n_iter"])
            dt = cv.time_to_lj(float(dyn["dt"]), unit=args["units"]["time"])
            self.integrator = str(dyn["integrator"]).lower()
            self.dequantizer = str(dyn.get("dequantizer", "argmax")).lower()
            self.dequant_scale = float(dyn.get("dequant_scale", 1.0))
        self.node_nf = node_nf

        for key, item in (("nbr_capacity", "items 2 and 5"),
                          ("compiler_options", "(TPU-only XLA flags)")):
            if dyn.get(key) is not None:
                raise NotImplementedError(
                    f"dynamics.{key} is not ported (ROADMAP queue A {item})")
        net_sec = dyn.get("network", {})
        self.flow_cfg = FlowConfig(
            n_iter=self.n_iter, dt=float(dt),
            egcl=EGCLConfig(node_nf=node_nf, hidden_nf=self.hidden_nf,
                            compute_dtype=dyn.get("compute_dtype"),
                            attention=bool(net_sec.get("attention", False)),
                            norm_diff=bool(net_sec.get("norm_diff", False)),
                            tanh=bool(net_sec.get("tanh", False)),
                            coords_weight=float(net_sec.get("coords_weight",
                                                            1.0)),
                            use_pallas=net_sec.get("use_pallas", False)),
            integrator=self.integrator,
            dequantizer=self.dequantizer,
            nbr_mode=dyn.get("nbr_mode", "dense"),
            exact_ldj=bool(dyn.get("exact_ldj", False)),
            remat=bool(dyn.get("remat", True)),
            remat_policy=dyn.get("remat_policy"),
            dequant_scale=self.dequant_scale,
            position_update=dyn.get("position_update", "shift"),
            pos_scale_max=float(dyn.get("pos_scale_max", 3.0)),
        )
        gen = torch.Generator().manual_seed(self.seed)
        self.params = init_flow(gen, self.flow_cfg, self.dtype, self.device)
        if hp is not None:
            tree, _ = load_checkpoint(self.checkpoint_path,
                                      {"params": self.params})
            self.params = tree["params"]
        eprint("In sample mode", flush=True)

    def _build_pos_target(self, section):
        from ..sample import targets as T

        ttype = section.get("type", "lj_cluster")
        n_atoms = int(section.get("n_atoms", 13))
        if "kBT" in section:
            kBT = float(section["kBT"])
        else:
            kBT = cv.kelvin_to_lj(float(section.get("temp", 300.0)))
        if ttype != "lj_cluster":
            raise NotImplementedError(
                f"target type {ttype!r} is not ported yet (ROADMAP queue A "
                "item 4); the port samples 'lj_cluster'")
        e_cap = section.get("e_cap")
        t = T.lj_cluster(n_atoms, kBT=kBT,
                         c_osc=float(section.get("c_osc", 0.5)),
                         softening=float(section.get("softening", 0.0)),
                         e_cap=None if e_cap is None else float(e_cap))
        return t, n_atoms

    def sample(self):
        """Flow-proposal SMC/AIS: writes an npz with particles and weights
        and prints a one-line summary."""
        sec = self.args["sampling"]
        algo_name = str(sec.get("algo", "smc")).lower()
        if algo_name not in ("smc", "ais"):
            raise NotImplementedError(
                f"sampling.algo={algo_name!r} is not ported yet (ROADMAP "
                "queue A item 8); the port runs smc | ais")
        for key in ("chunk_temps", "checkpoint_every", "metrics_csv"):
            if sec.get(key):
                raise NotImplementedError(
                    f"sampling.{key} is not ported yet (ROADMAP queue A "
                    "item 8)")
        target, n_atoms = self._build_pos_target(sec["target"])
        P = int(sec.get("n_particles", 1024))
        box = float(sec["target"].get("box", 1e3))
        r_cut = float(sec["target"].get("r_cut", 1e2))
        # the pushforward density needs the TRUE log-det (see the JAX driver)
        cfg = dataclasses.replace(self.flow_cfg, exact_ldj=True)
        propose_z, log_q0, log_p = flow_densities(self.params, cfg, target,
                                                  n_atoms, box, r_cut)
        return self._run_smc_ais(sec, algo_name, propose_z, log_q0, log_p, P,
                                 n_atoms)

    def _latents(self, gen, P, n_atoms):
        kw = dict(generator=gen, dtype=self.dtype, device=self.device)
        nf = self.node_nf
        return {"h": torch.randn((P, n_atoms, nf), **kw),
                "g": torch.randn((P, n_atoms, nf), **kw),
                "pos": torch.randn((P, n_atoms, 3), **kw),
                "vel": torch.randn((P, n_atoms, 3), **kw)}

    def _run_smc_ais(self, sec, algo_name, propose_z, log_q0, log_p, P,
                     n_atoms):
        from ..sample import ais as ais_fn
        from ..sample import smc as smc_fn
        from ..sample.smc import ess_from_log_weights

        extra = {}
        if algo_name == "smc":
            extra = dict(adaptive=bool(sec.get("adaptive", False)),
                         target_ess_frac=float(sec.get("target_ess_frac",
                                                       0.6)))
        knobs = dict(log_q0=log_q0, log_p=log_p,
                     n_temps=int(sec.get("n_temps", 10)),
                     mcmc_steps=int(sec.get("mcmc_steps", 1)),
                     step_size=float(sec.get("step_size", 0.02)),
                     n_leapfrog=int(sec.get("n_leapfrog", 5)),
                     adapt_step=bool(sec.get("adapt_step", False)),
                     target_accept=float(sec.get("target_accept", 0.65)),
                     precondition=bool(sec.get("precondition", False)),
                     **extra)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 31)
        x0 = propose_z(self._latents(gen, P, n_atoms))
        algo = smc_fn if algo_name == "smc" else ais_fn
        res = algo(gen, x0, **knobs)

        if res.beta_history is not None:
            beta_last = float(res.beta_history[-1])
            if beta_last < 1.0 - 1e-5:
                raise RuntimeError(
                    f"adaptive anneal incomplete: reached beta={beta_last:.4f}"
                    f" < 1 within n_temps={sec.get('n_temps', 10)} stages —"
                    f" raise sampling.n_temps (or train the flow further/"
                    f"lower target_ess_frac)")
        ess = float(ess_from_log_weights(res.log_weights))
        out_path = sec.get("output", "samples.npz")

        def host(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

        parts = {k: host(v) for k, v in res.particles.items()}
        np.savez(out_path, pos=parts["pos"], vel=parts["vel"], h=parts["h"],
                 g=parts["g"], log_weights=host(res.log_weights),
                 log_Z=host(res.log_Z), ess_history=host(res.ess_history),
                 **({"beta_history": host(res.beta_history)}
                    if res.beta_history is not None else {}))
        print(f"sampled {P} particles -> {out_path}  "
              f"log_Z={float(res.log_Z):.3f}  final_ESS={ess:.1f}  "
              f"accept={float(res.accept_history[-1]):.2f}", flush=True)
        return res

    def __call__(self, input_path):
        self.setup(input_path)
        return self.sample()
