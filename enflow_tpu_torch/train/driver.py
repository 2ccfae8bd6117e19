"""YAML-driven driver, the port of ``enflow_tpu/train/driver.py``.

Ported:

- ``mode: train`` with ``objective: nll`` on any dataset type of the JAX
  package (``lj``, the LJ MD simulated on the card; the readers ``md``,
  ``largemd``, ``trr``, ``xyz``, ``sdf``, ``hdf5``; ``lig``; ``compose``
  of ``dataset1`` ... ``dataset<number>``) in every neighbor mode but the
  atom-sharded ring: ``nbr_capacity: auto`` (the multi-image count in
  ``images`` mode, the port's own cell-list scan, ``native.py``, in the
  others),
  ``cells_per_dim``/``cell_capacity`` ints or ``auto`` for ``cell``, the
  one capacity check per dataset (neighbor count, cell occupancy, the
  ``box < 2 r_cut`` warning of the min-image modes), the per-epoch
  overflow of the truncating formats, Adam (with optional ``grad_clip``
  as optax's ``clip_by_global_norm`` and the staircase ``scheduler``), the
  per-epoch line in the JAX format, checkpoints every
  ``checkpoint_interval`` epochs and at the last, and resume from a
  checkpoint of either package (or a reference ``model.cpt`` imported by
  ``utils/torch_import.py``); ``training.profile_dir`` (a
  ``torch.profiler`` trace of the run's second epoch) and
  ``debug.nan_checks`` (``utils/observe.py``'s ``nan_guard``).
- ``mode: train`` with ``objective: flow_vi`` against an ``lj_cluster``,
  ``lj_fluid``, ``double_well``, ``gaussian`` or ``forcefield`` target
  (data-free), with any ``position_update``: the base draws, the
  reverse-KL loss with optional STL gradients, the softening / energy-cap /
  beta anneal, the optimizer chain that zeroes non-finite gradients before
  the clip (default 10), a checkpoint every epoch, resume from either
  package's checkpoint. ``fused_epoch`` is accepted and runs the same
  per-step loop.
- ``training.metrics_csv`` for both objectives (``utils/observe.py``).
- ``mode: generate``: the model from a checkpoint of either package, the
  LJ latent sampler's first frame reversed through the flow, ``h.out``,
  ``test_out.xyz`` and the round-trip check ``reverse(forward(out)) ==
  out`` for positions and features.
- ``mode: dataset``: the dataset alone, with its ``processed_file``
  cache and the simulated dataset's ``log`` and ``traj``.
- ``mode: sample`` with every ``sampling.algo``, over the same targets,
  from a checkpoint's hparams or from a fresh ``init_flow`` when the YAML
  gives ``dynamics.n_iter``, ``dt``, ``integrator`` and ``network``:
  ``smc | ais`` (flow-proposal SMC/AIS; for SMC ``chunk_temps`` segments
  with one retry on ``UNAVAILABLE``, ``checkpoint_every`` stage state
  files a killed run resumes from), ``hmc | mala | nuts`` (chains from
  flow draws on the target density), ``remc`` (flow-bridged parallel
  tempering with ``chunk_rounds`` and optional MBAR) and ``ti``
  (thermodynamic integration with ``chunk_steps``); ``sampling.
  metrics_csv``; a force-field target adds its dihedrals and phi/psi
  free-energy profiles to the npz. With a truncating neighbor format
  (``dynamics.nbr_capacity`` in ``dense``/``topk``, or ``cell``/
  ``images``) SMC/AIS probe the overflow at every stage and REMC once a
  round (``_overflow_stage_fn``): a warning with the total, the per-stage
  ``nbr_overflow`` column, REMC's total on its last row.
- ``parallel.atom_axis: K``: each molecule's atoms split over a mesh
  ``("data" = devices / K, "atom" = K)`` (``parallel/mesh.py``) — the NLL
  training through the ring flow and ring NLL (``flow/sharded.py``), the
  loader's ``n_max`` rounded up to a multiple of K; ``mode: generate``
  through the sharded flow; ``mode: sample`` with ``smc | ais | remc | ti``
  over the sharded densities (``sample/sharded.py``), atoms padded to a
  multiple of K and trimmed from the outputs. The devices are the
  process group's ranks, or, in one process, ``Main(virtual_devices=K)``
  (``--virtual-devices``), the in-process form on one device; K must
  divide their count, as in the JAX driver.
- Several processes (``parallel/mesh.py:maybe_initialize_distributed``,
  torchrun's or SLURM's environment; NCCL on cards): NLL training data
  parallel (the loader's ``shard``, ``batch_size`` per process, the
  parameter gradients summed over the ranks) and atom-sharded; flow-VI
  with the particles split over the data axis; sampling with the
  densities' particles split over the chain axis (``split_rows``: the
  sampler runs whole on every rank from the same generators); only rank
  0 prints and writes.

The config schema, checkpoints, npz outputs and printed lines are the JAX
driver's.

The SMC runs batched: the densities see all particles at once, so on the
card each EGCL is one launch of the fused kernel over the particle batch.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch
import yaml

from .. import resolve_device
from ..data import formats, transforms
from ..data.datasets import DataLoader, get_dataset_class
from ..data.neighbors import image_edge_max
from ..data.system import System
from ..flow.integrators import (FlowConfig, init_flow, forward,
                                forward_core, reverse, reverse_core)
from ..flow.loss import alchemical_nll
from ..flow.sharded import draw_noise
from ..nn.egcl import EGCLConfig
from ..parallel import mesh as mesh_lib
from ..utils import conversion as cv
from ..utils.constants import sigma
from ..utils.jax_params import tree_flatten
from ..utils.observe import (MetricsLogger, assert_all_finite, nan_guard,
                             profile_trace)
from .checkpoint import (has_tree, load_checkpoint, load_hparams,
                         save_checkpoint)
from .optim import NLLOptimizer

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, **kwargs)


def write_xyz(path, pos_reduced, symbol="Ar"):
    """Reduced-unit positions as an Angstrom XYZ file (``x * sigma *
    1e10``, ``driver.py:54-58``)."""
    pos_ang = np.asarray(pos_reduced) * sigma * 1e10
    formats.write_xyz(path, [symbol] * pos_ang.shape[0], pos_ang)


def vi_anneal(tgt_sec: dict):
    """The flow-VI anneal of ``training.target.anneal``
    (``enflow_tpu/train/driver.py:854-894``) as ``epoch -> (softening,
    e_cap, beta)``, or None without an anneal: the softening and beta go
    linearly from their start values to the target's final ones over
    ``epochs``, the cap harmonically (``1/cap`` linear, the final cap
    infinite when the target has none), capped at float32's largest
    value."""
    anneal = tgt_sec.get("anneal")
    if not anneal:
        return None
    if tgt_sec.get("type", "lj_cluster") not in ("lj_cluster", "lj_fluid"):
        raise ValueError("training.target.anneal is supported for lj_cluster "
                         "and lj_fluid targets")
    s_final = float(tgt_sec.get("softening", 0.0))
    s_start = float(anneal.get("softening_start", s_final))
    cap_final = tgt_sec.get("e_cap")
    cap_final = math.inf if cap_final is None else float(cap_final)
    cap_start = float(anneal.get("e_cap_start", cap_final))
    anneal_epochs = max(1, int(anneal.get("epochs", 1)))
    beta_start = float(anneal.get("beta_start", 1.0))
    if not 0.0 < beta_start <= 1.0:
        raise ValueError(
            f"training.target.anneal.beta_start must be in (0, 1] (got "
            f"{beta_start}): beta=0 is an improper flat target, beta<0 "
            f"inverts it")
    f32_max = float(np.finfo(np.float32).max)

    def schedule(epoch: int):
        frac = max(0.0, 1.0 - epoch / anneal_epochs)
        inv = frac / cap_start + (0.0 if math.isinf(cap_final)
                                  else (1.0 - frac) / cap_final)
        cap = math.inf if inv == 0.0 else 1.0 / inv
        return (s_final + (s_start - s_final) * frac, min(cap, f32_max),
                1.0 + (beta_start - 1.0) * frac)

    return schedule


def _host(t) -> np.ndarray:
    """A tensor as a numpy array on the host (bfloat16 as float32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _max_occupancy(pos, box, m: int) -> int:
    """The most atoms one of the ``m^3`` cells holds in a frame ``pos
    [N,3]`` (``celllist.max_cell_occupancy`` on the host)."""
    from ..data.celllist import max_cell_occupancy
    pos = torch.as_tensor(np.asarray(pos, np.float64))[None]
    box = torch.as_tensor(np.asarray(box, np.float64))[None]
    mask = torch.ones(pos.shape[:2], dtype=torch.bool)
    return int(max_cell_occupancy(pos, box, mask, m))


def _topk_truncates(main) -> bool:
    """True when ``main``'s min-image mode keeps a top-K capacity below
    the batch's atoms."""
    cfg = main.flow_cfg
    loader = getattr(main, "train_loader", None)
    n_max = loader.n_max if loader is not None else None
    return (cfg.nbr_mode in ("dense", "topk", "cell")
            and cfg.nbr_capacity is not None
            and (n_max is None or cfg.nbr_capacity < n_max))


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
    caller passes ``"cpu"``; without a card it raises. ``virtual_devices``
    is the device count of the in-process mesh (``parallel/mesh.py``); with
    several processes the ranks are the devices."""

    def __init__(self, device=None, virtual_devices: int = 1):
        self.device = resolve_device(device)
        mesh_lib.maybe_initialize_distributed(self.device)
        self.process_index = mesh_lib.process_index()
        self.num_processes = mesh_lib.process_count()
        self.is_main = self.process_index == 0
        self.virtual_devices = int(virtual_devices)

    def setup(self, input_path):
        with open(input_path) as f:
            args = yaml.safe_load(f)
        self.args = args
        self.start_epoch = 0

        mode = args.get("mode", "train")
        if mode not in ("train", "sample", "generate", "dataset"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.dtype = _DTYPES[args.get("precision", "float32")]
        self.seed = int(args.get("seed", 0))
        self.objective = None
        if mode == "train":
            self._check_train_options(args)
            self.objective = args.get("training", {}).get("objective", "nll")
        self._setup_mesh(args)

        dyn = args.get("dynamics", {})
        self.checkpoint_path = dyn.get("checkpoint_path", "")
        hp = None
        node_nf = None
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
            if mode in ("train", "generate"):
                self.lj_kBT = hp["lj_kBT"]
                self.softening = hp["softening"]
        elif mode == "generate":
            raise ValueError(
                f"generate mode requires an existing checkpoint at "
                f"{self.checkpoint_path!r}: the model architecture comes "
                f"from it")
        elif mode != "dataset":
            if mode == "sample":
                node_nf = int(dyn["network"]["node_nf"])
            self.hidden_nf = int(dyn["network"]["hidden_nf"])
            self.n_iter = int(dyn["n_iter"])
            dt = cv.time_to_lj(float(dyn["dt"]), unit=args["units"]["time"])
            self.integrator = str(dyn["integrator"]).lower()
            self.dequantizer = str(dyn.get("dequantizer", "argmax")).lower()
            self.dequant_scale = float(dyn.get("dequant_scale", 1.0))
            if mode == "train":
                loss_sec = args.get("training", {}).get("loss", {})
                self.lj_kBT = cv.kelvin_to_lj(float(loss_sec.get("temp",
                                                                 300.0)))
                self.softening = float(loss_sec.get("softening", 0.0))

        # dynamics.compiler_options holds XLA flags for a TPU; the JAX
        # driver drops them on cpu/gpu (driver.py:305-313), so does the port
        nbr_capacity = dyn.get("nbr_capacity")
        self.dataset = None
        if mode == "dataset":
            # the dataset alone: its cache, log and traj (driver.py:213-214)
            self.dataset = self._build_dataset(args)
            return
        if mode == "generate":
            # the model's facts go to the latent sampler
            # (driver.py:175-183)
            args["dataset"]["node_nf"] = node_nf
            args["dataset"]["softening"] = self.softening
            args["dataset"]["temp"] = cv.lj_to_kelvin(self.lj_kBT)
            self.dataset = self._build_dataset(args)
            self.train_loader = self._loader(1, shuffle=False)
            nbr_capacity = self._auto_capacity(dyn, nbr_capacity)
        elif self.objective == "flow_vi":
            # data-free (driver.py:204-221): node_nf from the network
            if node_nf is None:
                node_nf = int(dyn["network"]["node_nf"])
            if nbr_capacity == "auto":
                raise ValueError("nbr_capacity: auto requires a dataset")
            if nbr_capacity is not None:
                nbr_capacity = int(nbr_capacity)
        elif mode == "train":
            self.dataset = self._build_dataset(args)
            if node_nf is None:
                node_nf = self.dataset.node_nf
            tr = args["training"]
            batch_size = int(tr.get("batch_size", args.get(
                "dataset", {}).get("batch_size", 1)))
            n_data = self.mesh.shape["data"]
            if self.atom_axis > 1 and batch_size % n_data:
                raise ValueError(
                    f"batch_size={batch_size} must be divisible by the data "
                    f"axis ({n_data} = devices / atom_axis "
                    f"{self.atom_axis})")
            self.train_loader = self._loader(
                batch_size, shuffle=True, prefetch=int(tr.get("prefetch", 2)))
            nbr_capacity = self._auto_capacity(dyn, nbr_capacity)
        elif nbr_capacity is not None:
            # sampling is data-free: a fixed capacity, watched by the
            # per-stage / per-round overflow probe (_overflow_stage_fn)
            if nbr_capacity == "auto":
                raise ValueError("nbr_capacity: auto requires a dataset")
            nbr_capacity = int(nbr_capacity)
        self.node_nf = node_nf

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
            nbr_capacity=nbr_capacity,
            nbr_mode=dyn.get("nbr_mode", "dense"),
            **self._cell_params(dyn),
            exact_ldj=bool(dyn.get("exact_ldj", False)),
            remat=bool(dyn.get("remat", True)),
            remat_policy=dyn.get("remat_policy"),
            dequant_scale=self.dequant_scale,
            position_update=dyn.get("position_update", "shift"),
            pos_scale_max=float(dyn.get("pos_scale_max", 3.0)),
        )
        gen = torch.Generator().manual_seed(self.seed)
        self.params = init_flow(gen, self.flow_cfg, self.dtype, self.device)
        if mode in ("sample", "generate") and hp is not None:
            tree, _ = load_checkpoint(self.checkpoint_path,
                                      {"params": self.params})
            self.params = tree["params"]
        if mode == "sample":
            eprint("In sample mode", flush=True)
            return

        # one loud capacity check per dataset: 'auto' sizes from the first
        # frame only (opt out with dynamics.validate_capacity: false)
        if dyn.get("validate_capacity", True):
            self._validate_capacities()
        if mode == "generate":
            eprint("In generate mode", flush=True)
            return
        self._setup_optimizer(args["training"])
        if self.objective == "flow_vi":
            self._setup_vi(args["training"])
        if hp is not None:
            self._restore(hp)
        mesh_lib.replicate(self.params, self.mesh)
        eprint("In training mode", flush=True)

    def _setup_mesh(self, args):
        """The mesh of ``parallel.atom_axis`` and its refusals
        (``driver.py:223-264``): K > 1 needs K to divide the device count
        and gives ``("data", "atom")``; otherwise ``("data",)`` over every
        device."""
        self.atom_axis = int(args.get("parallel", {}).get("atom_axis", 1))
        n_dev = (self.num_processes if self.num_processes > 1
                 else self.virtual_devices)
        if self.atom_axis > 1:
            if n_dev % self.atom_axis:
                raise ValueError(
                    f"parallel.atom_axis={self.atom_axis} must divide the "
                    f"device count ({n_dev})")
            self.mesh = mesh_lib.get_mesh(
                ("data", "atom"), (n_dev // self.atom_axis, self.atom_axis),
                virtual_devices=self.virtual_devices)
        else:
            self.mesh = mesh_lib.get_mesh(
                ("data",), virtual_devices=self.virtual_devices)

    def _loader(self, batch_size, shuffle, prefetch=0):
        """The dataset's loader: this data shard's samples (``shard``),
        ``n_max`` rounded up to a multiple of the atom axis
        (``driver.py:266-278``)."""
        dx = self.mesh["data"]
        loader = DataLoader(self.dataset, batch_size=batch_size,
                            shuffle=shuffle, seed=self.seed, dtype=self.dtype,
                            device=self.device, prefetch=prefetch,
                            shard=(dx.size, dx.index))
        k = self.atom_axis
        loader.n_max = -(-loader.n_max // k) * k
        return loader

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    def _check_train_options(self, args):
        tr = args.get("training", {})
        objective = tr.get("objective", "nll")
        if objective not in ("nll", "flow_vi"):
            raise ValueError(f"unknown training.objective {objective!r}")
        # the NLL trainer's observability (driver.py:424-425): a profiler
        # trace of the run's second epoch, and the NaN guard
        self.profile_dir = tr.get("profile_dir")
        self.nan_checks = bool(args.get("debug", {}).get("nan_checks"))

    def _build_dataset(self, args):
        """The ``dataset`` section's dataset; ``type: compose``
        concatenates ``dataset1`` ... ``dataset<number>``
        (``driver.py:202-209``)."""
        if args["dataset"]["type"] == "compose":
            from ..data.datasets import ComposeDatasets
            n = int(args["dataset"]["number"])
            return ComposeDatasets([self._setup_dataset(f"dataset{i + 1}",
                                                        args)
                                    for i in range(n)])
        return self._setup_dataset("dataset", args)

    def _setup_dataset(self, dataset_label, args):
        """Resolve the dataset class and build the standard transforms
        (``driver.py:100-127``); a simulated dataset runs on the driver's
        device."""
        section = dict(args[dataset_label])
        cls = get_dataset_class(section.pop("type"))
        section.pop("batch_size", None)
        section["dist_unit"] = args["units"]["dist"]
        section["time_unit"] = args["units"]["time"]
        if "r_cut" not in section and "r_cut" in args.get("dynamics", {}):
            section["r_cut"] = args["dynamics"]["r_cut"]
        section.setdefault("seed", int(args.get("seed", 0)))
        T = [transforms.ConvertPositionsFrom(args["units"]["dist"]),
             transforms.Center()]
        if section.pop("randomize_vel", False):
            T.append(transforms.RandomizeVelocity(
                cv.kelvin_to_lj(float(section.pop("temp"))),
                seed=section["seed"] + 1))
        else:
            T.append(transforms.ConvertVelocitiesFrom(
                args["units"]["dist"], args["units"]["time"]))
        return cls(**section, transform=transforms.Compose(T),
                   device=self.device)

    def _auto_capacity(self, dyn, nbr_capacity):
        """``nbr_capacity: auto`` (``driver.py:284-301``) from the first
        frame: in ``images`` mode its largest (neighbor, image) slot count,
        otherwise its largest min-image neighbor count by the cell-list
        scan (``native.suggest_capacity``), each x 1.25 rounded up to a
        multiple of 8, at least 8."""
        if nbr_capacity != "auto":
            return None if nbr_capacity is None else int(nbr_capacity)
        if self.dataset is None or not len(self.dataset):
            raise ValueError("nbr_capacity: auto requires a dataset")
        s0 = self.dataset[0]
        pos = np.asarray(s0.pos, np.float64)
        box = np.asarray(s0.box, np.float64)
        if dyn.get("nbr_mode") == "images":
            mx = image_edge_max(pos, box, float(s0.r_cut))
            cap = int(np.ceil(mx * 1.25))
            cap = max(8, ((cap + 7) // 8) * 8)
        else:
            from .. import native
            cap = native.suggest_capacity(pos, box, float(s0.r_cut))
        eprint(f"nbr_capacity: auto -> {cap}", flush=True)
        return cap

    def _cell_params(self, dyn):
        """``cells_per_dim`` and ``cell_capacity`` for ``nbr_mode: cell``
        (``driver.py:472-500``): ints, or from the first frame when
        ``auto`` or omitted (the densest cell's occupancy x 1.5, at least
        4)."""
        if dyn.get("nbr_mode") != "cell":
            return {}
        from ..data.celllist import suggest_cells_per_dim
        m = dyn.get("cells_per_dim", "auto")
        cap = dyn.get("cell_capacity", "auto")
        if m == "auto" or cap == "auto":
            if self.dataset is None or not len(self.dataset):
                raise ValueError(
                    "nbr_mode: cell with auto parameters requires a dataset")
            s0 = self.dataset[0]
            if m == "auto":
                m = suggest_cells_per_dim(s0.box, s0.r_cut)
            if cap == "auto":
                occ = _max_occupancy(np.asarray(s0.pos), s0.box, int(m))
                cap = max(4, int(np.ceil(occ * 1.5)))
            eprint(f"cell list: cells_per_dim={m}, cell_capacity={cap}",
                   flush=True)
        return {"cells_per_dim": int(m), "cell_capacity": int(cap)}

    def _validate_capacities(self):
        """One host-side capacity check per dataset (``driver.py:502-655``)
        over up to ``dynamics.validate_max_frames`` frames (default 64,
        spread evenly, announced when it subsamples; 0 scans every frame):
        the neighbor count (``native.neighbor_counts``; (neighbor, image)
        slots in ``images`` mode) against ``nbr_capacity`` and, in ``cell``
        mode, the densest cell against ``cell_capacity``. Raises with the
        recommended values (the observed maximum x
        ``dynamics.capacity_headroom``, default 1.25) when a frame would
        drop edges, warns when a capacity is below its recommendation, and
        warns loudly when the min-image modes see ``box < 2 r_cut``."""
        cfg = self.flow_cfg
        if self.dataset is None or not len(self.dataset):
            return
        dyn = self.args.get("dynamics", {})
        n_total = len(self.dataset)
        max_frames = int(dyn.get("validate_max_frames", 64))
        if max_frames > 0 and n_total > max_frames:
            idxs = np.unique(np.linspace(0, n_total - 1, max_frames,
                                         dtype=int))
            eprint(f"capacity check: sampling {len(idxs)} of {n_total} "
                   f"frames (dynamics.validate_max_frames={max_frames}; "
                   f"set 0 to scan every frame)", flush=True)
        else:
            idxs = np.arange(n_total)
        check_nbr = _topk_truncates(self)
        check_images = cfg.nbr_mode == "images"
        check_cell = cfg.nbr_mode == "cell"
        check_box = cfg.nbr_mode in ("dense", "topk", "cell")
        if not (check_nbr or check_cell or check_images or check_box):
            return

        from .. import native
        max_nbr, max_occ = 0, 0
        min_box, max_rc = np.inf, 0.0
        for i in idxs:
            s = self.dataset[int(i)]
            pos = np.asarray(s.pos, np.float64)
            box = np.asarray(s.box, np.float64)
            min_box = min(min_box, float(box.min()))
            max_rc = max(max_rc, float(s.r_cut))
            if check_nbr:
                _, mx = native.neighbor_counts(pos, box, float(s.r_cut))
                max_nbr = max(max_nbr, mx)
            if check_images:
                max_nbr = max(max_nbr, image_edge_max(pos, box,
                                                      float(s.r_cut)))
            if check_cell:
                max_occ = max(max_occ, _max_occupancy(
                    pos, box, int(cfg.cells_per_dim)))

        # the min-image modes keep one edge a pair; with box < 2 r_cut a
        # pair interacts through several images ('images' mode)
        if check_box and min_box < 2.0 * max_rc:
            import warnings
            msg = (f"box < 2*r_cut (min box {min_box:.3g} < "
                   f"{2 * max_rc:.3g}): the min-image neighbor mode "
                   f"'{cfg.nbr_mode}' keeps one edge per pair, but in "
                   "this regime pairs interact through multiple "
                   "periodic images (one edge per in-cutoff image). "
                   "Set dynamics.nbr_mode: images for the full "
                   "multi-image edge set.")
            warnings.warn(msg)
            eprint("WARNING: " + msg, flush=True)
        if not (check_nbr or check_cell or check_images):
            return
        factor = float(dyn.get("capacity_headroom", 1.25))
        rec_nbr = int(np.ceil(max_nbr * factor))
        rec_occ = int(np.ceil(max_occ * factor))
        errs = []
        if (check_nbr or check_images) and max_nbr > (cfg.nbr_capacity
                                                      or 10 ** 9):
            kind = ("in-cutoff (neighbor, image) slots" if check_images
                    else "in-cutoff neighbors")
            errs.append(
                f"nbr_capacity={cfg.nbr_capacity} is too small: an atom in "
                f"this dataset has {max_nbr} {kind} — edges "
                f"would be silently dropped. Recommended "
                f"dynamics.nbr_capacity >= {rec_nbr} ({max_nbr} observed x "
                f"{factor:g} capacity_headroom for mid-flow motion)")
        if check_cell and max_occ > cfg.cell_capacity:
            errs.append(
                f"cell_capacity={cfg.cell_capacity} is too small: a cell in "
                f"this dataset holds {max_occ} atoms — candidates would be "
                f"silently dropped. Recommended dynamics.cell_capacity >= "
                f"{rec_occ} ({max_occ} observed x {factor:g} "
                f"capacity_headroom for mid-flow motion)")
        if errs:
            raise ValueError("; ".join(errs) +
                             " (or set dynamics.validate_capacity: false)")
        low = []
        if (check_nbr or check_images) and cfg.nbr_capacity is not None \
                and cfg.nbr_capacity < rec_nbr:
            low.append(f"nbr_capacity {cfg.nbr_capacity} < recommended "
                       f"{rec_nbr} ({max_nbr} observed x {factor:g})")
        if check_cell and cfg.cell_capacity < rec_occ:
            low.append(f"cell_capacity {cfg.cell_capacity} < recommended "
                       f"{rec_occ} ({max_occ} observed x {factor:g})")
        eprint(f"capacity check: max neighbors {max_nbr}"
               + (f", max cell occupancy {max_occ}" if check_cell else "")
               + " — within capacity", flush=True)
        if low:
            eprint("WARNING: capacity below the mid-flow headroom "
                   "recommendation (" + "; ".join(low) + ") — the "
                   "runtime overflow counter (metrics CSV "
                   "`nbr_overflow`) will report any truncation",
                   flush=True)

    def _capacity_can_truncate(self) -> bool:
        """True when the neighbor format can drop edges: a top-K capacity
        below the batch's atoms, cell binning, or image slots."""
        return (self.flow_cfg.nbr_mode in ("cell", "images")
                or _topk_truncates(self))

    def _setup_optimizer(self, tr):
        """Adam with optional ``grad_clip`` and staircase ``scheduler``
        (``train/optim.py``) over the flattened parameters; for flow-VI the
        clip defaults to 10 and non-finite gradients are zeroed first
        (``driver.py:385-411``)."""
        sched = tr.get("scheduler")
        if isinstance(sched, str) and sched.lower() in ("no", "false",
                                                        "none", "off"):
            sched = False
        vi = self.objective == "flow_vi"
        clip = tr.get("grad_clip", 10.0 if vi else None)
        self._leaves, _ = tree_flatten(self.params)
        for t in self._leaves:
            t.requires_grad_(True)
        self.optimizer = NLLOptimizer(
            self._leaves, float(tr["lr"]),
            schedule=((int(float(tr["scheduler_step"])), float(tr["gamma"]))
                      if sched else None),
            grad_clip=float(clip) if clip else None, zero_nonfinite=vi)
        self.num_epochs = int(tr["num_epochs"])
        self.log_interval = int(tr["log_interval"])
        self.checkpoint_interval = int(tr.get("checkpoint_interval", 1))
        self.metrics = self._logger(tr.get("metrics_csv"))
        eprint(f"Loss function parameters: softening={self.softening}, "
               f"kBT={self.lj_kBT}", flush=True)

    def _restore(self, hp):
        """Resume params and optimizer from the checkpoint (either
        package's), continuing at ``epoch + 1``."""
        template = {"params": self.params}
        if has_tree(self.checkpoint_path, "opt_state"):
            template["opt_state"] = self.optimizer.state_leaves()
        else:
            eprint("checkpoint has no optimizer state (imported?); starting "
                   "with a fresh optimizer", flush=True)
        try:
            tree, _ = load_checkpoint(self.checkpoint_path, template)
        except ValueError as e:
            if "opt_state" not in str(e):
                raise
            eprint(f"optimizer state incompatible ({e}); starting with a "
                   "fresh optimizer", flush=True)
            template.pop("opt_state")
            tree, _ = load_checkpoint(self.checkpoint_path, template)
        loaded, _ = tree_flatten(tree["params"])
        with torch.no_grad():
            for p, v in zip(self._leaves, loaded):
                p.copy_(v)
        if "opt_state" in tree:
            self.optimizer.load_state_leaves(tree["opt_state"])
        self.start_epoch = int(hp["epoch"]) + 1

    def _save(self, epoch):
        if not self.is_main:
            return
        hparams = {
            "epoch": int(epoch),
            "node_nf": int(self.node_nf),
            "hidden_nf": int(self.hidden_nf),
            "softening": float(self.softening),
            "lj_kBT": float(self.lj_kBT),
            "integrator": self.integrator,
            "dequantizer": self.dequantizer,
            "dequant_scale": float(self.flow_cfg.dequant_scale),
            "n_iter": int(self.n_iter),
            "dt": float(self.flow_cfg.dt),
        }
        save_checkpoint(self.checkpoint_path,
                        {"params": self.params,
                         "opt_state": self.optimizer.state_leaves()},
                        hparams)

    def _savez(self, path, **arrays):
        """``np.savez`` by rank 0 (every rank holds the same results)."""
        if self.is_main:
            np.savez(path, **arrays)

    def _logger(self, path):
        """A metrics CSV written by rank 0."""
        return MetricsLogger(path if self.is_main else None)

    def train_step(self, batch, gen):
        """One NLL step: forward with the dequantizer noise from ``gen``,
        the NLL, its gradient (summed over the ranks), clipping, Adam.
        Atom-sharded (``parallel.atom_axis``) the forward and the NLL are
        the ring ones (``flow/sharded.py``). Returns the loss and the
        overflow count (device tensors; no host sync unless the NaN guard
        is on, which reads the loss before the backward)."""
        cfg = self.flow_cfg
        eps = self._noise(gen, batch.h)
        n_lg = 3 if cfg.dequantizer == "argmax" else 2
        ovf = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.atom_axis > 1:
            from ..flow.sharded import make_sharded_nll
            loss = make_sharded_nll(
                self.mesh, cfg, self.lj_kBT, self.softening,
                num_log_gaussian_calls=n_lg, data_axis="data")(
                    self.params, batch, eps=eps)
        else:
            if self._capacity_can_truncate():
                cfg = dataclasses.replace(cfg, track_overflow=True)
                out, ldj, ovf = forward(self.params, cfg, batch, eps=eps)
            else:
                out, ldj = forward(self.params, cfg, batch, eps=eps)
            loss = alchemical_nll(out, ldj, self.lj_kBT, self.softening,
                                  num_log_gaussian_calls=n_lg,
                                  data_axis=self.mesh["data"])
        self._nan_check(loss, "loss")
        self.optimizer.zero_grad()
        loss.backward()
        mesh_lib.sum_grads(self._leaves)
        self.optimizer.step()
        return loss.detach(), ovf

    def _noise(self, gen, h):
        """The dequantizer noise of a batch ``h``: the draw of the global
        batch (every data shard's rows) and this shard's rows of it, ``r::R``
        as the loader's ``shard`` takes samples, so that R ranks draw what
        one process draws for their global batch."""
        dx = self.mesh["data"]
        return draw_noise(self.flow_cfg, gen, h,
                          h.shape[0] * dx.size)[dx.index::dx.size]

    def _noise_seed(self, epoch: int) -> int:
        """The dequantizer noise's seed of one epoch: a resumed run draws
        what an uninterrupted one draws."""
        return ((self.seed + 17) * 1_000_003 + epoch) % (2 ** 63)

    def train(self):
        if self.objective == "flow_vi":
            self._train_vi()
        else:
            self._train_nll()

    def _nan_check(self, tree, name):
        """The NaN guard's forward check while it is on, else nothing."""

    def _train_nll(self):
        print('Epoch \tTraining Loss \t   Time (s)', flush=True)
        for epoch in range(self.start_epoch,
                           self.start_epoch + self.num_epochs):
            self.train_loader.set_epoch(epoch)
            eprint(f"###### Starting epoch {epoch} ######", flush=True)
            start_time = time.time()
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._noise_seed(epoch))
            # profile the second epoch of this run (the first one warms up)
            do_profile = (self.profile_dir and self.is_main
                          and epoch == self.start_epoch + 1)
            with profile_trace(self.profile_dir if do_profile else None), \
                    nan_guard(self.nan_checks) as check:
                self._nan_check = check
                try:
                    losses, ovfs = [], []
                    for batch in self.train_loader:
                        loss, ovf = self.train_step(batch, gen)
                        losses.append(loss)
                        ovfs.append(ovf)
                    losses = torch.stack(losses)
                    epoch_ovf = int(torch.stack(ovfs).sum())
                finally:
                    del self._nan_check
            if self.nan_checks:
                assert_all_finite(losses, "epoch losses")
            epoch_loss = float(losses.mean())
            if epoch_ovf:
                eprint(f"WARNING: epoch {epoch} truncated {epoch_ovf} "
                       f"neighbor slots mid-flow (nbr_capacity/"
                       f"cell_capacity too small for in-flow motion) — "
                       f"raise the capacity or dynamics.capacity_headroom",
                       flush=True)
            last = epoch == self.start_epoch + self.num_epochs - 1
            if self.checkpoint_path and (
                    epoch % self.checkpoint_interval == 0 or last):
                self._save(epoch)
                eprint("State saved", flush=True)
            end_time = time.time()
            lr = self.optimizer.lr_at(self.optimizer.steps_taken)
            if epoch % self.log_interval == 0:
                print('%.5i \t    %.2f \t    %.2f \t    %.2e'
                      % (epoch, epoch_loss, end_time - start_time, lr),
                      flush=True)
            self.metrics.log(epoch=epoch, loss=epoch_loss,
                             epoch_seconds=end_time - start_time, lr=lr,
                             batches=len(self.train_loader),
                             nbr_overflow=epoch_ovf)
            eprint(f"###### Ending epoch {epoch} ###### ", flush=True)
        self.metrics.close()

    # ------------------------------------------------------------------
    # flow-VI
    # ------------------------------------------------------------------

    def _setup_vi(self, tr):
        """The flow-VI target, base and anneal (``driver.py:833-906``)."""
        from ..sample.vi import make_base_log_prob

        tgt_sec = tr["target"]
        self.vi_target, self.vi_n_atoms = self._build_pos_target(tgt_sec)
        self.vi_kBT_aux = float(tgt_sec.get("kBT_aux", 1.0))
        self.vi_particles = int(tr.get("n_particles", 256))
        self.vi_steps_per_epoch = int(tr.get("steps_per_epoch", 100))
        base = tr.get("base", {})
        self.vi_stds = {k: float(base.get(k, 1.0))
                        for k in ("pos_std", "vel_std", "feat_std")}
        self.vi_box = float(tgt_sec.get("box", 1e3))
        self.vi_r_cut = float(tgt_sec.get("r_cut", 1e2))
        self.vi_stl = bool(tr.get("stl", False))
        self.vi_base_lp = make_base_log_prob(**self.vi_stds)
        self.vi_schedule = vi_anneal(tgt_sec)
        # the particles split over the data axis (driver.py:910-932)
        n_data = self.mesh["data"].size
        self.vi_shard = self.vi_particles % n_data == 0
        if not self.vi_shard:
            eprint(f"flow_vi: n_particles={self.vi_particles} not divisible "
                   f"by {n_data} devices; running unsharded", flush=True)

    def _vi_system_target(self, epoch: int):
        """The System target of one epoch: the position target at that
        epoch's anneal values (softening, cap, beta), else as configured."""
        from ..sample.vi import make_system_target

        if self.vi_schedule is None:
            return make_system_target(self.vi_target.log_prob,
                                      kBT_aux=self.vi_kBT_aux)
        soft, cap, beta = self.vi_schedule(epoch)
        log_prob = self.vi_target.log_prob
        return make_system_target(
            lambda x: beta * log_prob(x, softening=soft, e_cap=cap),
            kBT_aux=self.vi_kBT_aux)

    def _vi_seed(self, epoch: int, step: int) -> int:
        """The base draws' seed of one step: a resumed run draws what an
        uninterrupted one draws."""
        return (((self.seed + 23) * 1_000_003 + epoch) * 1_000_033
                + step) % (2 ** 63)

    def vi_step(self, gen, target):
        """One flow-VI step: the base batch from ``gen``, the loss and its
        gradients, the optimizer chain. Returns the loss and 1.0 when a
        gradient was non-finite (device tensors; no host sync)."""
        from ..sample.vi import flow_vi_loss, sample_base

        batch = sample_base(gen, self.vi_particles, self.vi_n_atoms,
                            self.node_nf, box=self.vi_box,
                            r_cut=self.vi_r_cut, dtype=self.dtype,
                            device=self.device, **self.vi_stds)
        dx = self.mesh["data"]
        if self.vi_shard:       # this rank's particles of the whole draw
            batch = mesh_lib.shard_batch(batch, self.mesh)
        loss, _ = flow_vi_loss(self.params, self.flow_cfg, batch, target,
                               stl=self.vi_stl,
                               base_log_prob=self.vi_base_lp)
        if self.vi_shard:       # the mean over every rank's particles
            loss = dx.psum(loss) / dx.size
        self.optimizer.zero_grad()
        loss.backward()
        if self.vi_shard:
            mesh_lib.sum_grads(self._leaves, dx)
        finite = torch.stack([torch.isfinite(p.grad).all()
                              for p in self._leaves if p.grad is not None])
        bad = 1.0 - finite.all().to(loss.dtype)
        self.optimizer.step()
        return loss.detach(), bad

    def _train_vi(self):
        """Data-free flow-VI training (``driver.py:827-1038``): one
        checkpoint, epoch line and metrics row per epoch."""
        print('Epoch \tVI Loss \t   Time (s)', flush=True)
        n_steps = self.vi_steps_per_epoch
        for epoch in range(self.start_epoch,
                           self.start_epoch + self.num_epochs):
            start_time = time.time()
            target = self._vi_system_target(epoch)
            losses, bads = [], []
            for i in range(n_steps):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self._vi_seed(epoch, i))
                loss, bad = self.vi_step(gen, target)
                losses.append(loss)
                bads.append(bad)
            losses = torch.stack(losses).float().cpu().numpy()
            nan_steps = int(torch.stack(bads).sum())
            if nan_steps:
                eprint(f"epoch {epoch}: {nan_steps}/{n_steps} steps had "
                       f"nonfinite gradients (skipped by the optimizer "
                       f"guard)", flush=True)
            if self.checkpoint_path:
                self._save(epoch)
            end_time = time.time()
            # the mean over the finite losses (a guarded step's NaN loss
            # does not mask the others)
            finite = losses[np.isfinite(losses)]
            epoch_loss = float(finite.mean()) if finite.size else math.nan
            lr = self.optimizer.lr_at(self.optimizer.steps_taken)
            if epoch % self.log_interval == 0:
                print('%.5i \t    %.2f \t    %.2f \t    %.2e'
                      % (epoch, epoch_loss, end_time - start_time, lr),
                      flush=True)
            self.metrics.log(epoch=epoch, loss=epoch_loss,
                             epoch_seconds=end_time - start_time, lr=lr,
                             batches=n_steps)
        self.metrics.close()

    def _build_pos_target(self, section):
        """The position target of a ``training.target`` or
        ``sampling.target`` section (``driver.py:763-827``)."""
        from ..sample import targets as T

        ttype = section.get("type", "lj_cluster")
        n_atoms = int(section.get("n_atoms", 13))
        if "kBT" in section:
            kBT = float(section["kBT"])
        else:
            kBT = cv.kelvin_to_lj(float(section.get("temp", 300.0)))
        e_cap = section.get("e_cap")
        e_cap = None if e_cap is None else float(e_cap)
        if ttype == "lj_cluster":
            t = T.lj_cluster(n_atoms, kBT=kBT,
                             c_osc=float(section.get("c_osc", 0.5)),
                             softening=float(section.get("softening", 0.0)),
                             e_cap=e_cap)
        elif ttype == "lj_fluid":
            # `box` doubles as the System box of the VI base draws and the
            # sampler's flow (both read the same key)
            if "box" not in section:
                raise ValueError("target type 'lj_fluid' requires 'box' "
                                 "(reduced units, same as positions)")
            cut = section.get("cutoff")
            t = T.lj_fluid(n_atoms, box=float(section["box"]), kBT=kBT,
                           softening=float(section.get("softening", 0.0)),
                           cutoff=None if cut is None else float(cut),
                           e_cap=e_cap)
        elif ttype == "double_well":
            t = T.double_well(n_atoms, dim=3, kBT=kBT)
        elif ttype == "gaussian":
            t = T.gaussian((n_atoms, 3), std=float(section.get("std", 1.0)))
        elif ttype == "forcefield":
            # molecular force field, parameters inline under 'params' or in
            # 'params_file'; the Coulomb constant from the target section,
            # else the params file, else 1.0 (driver.py:798-817)
            from ..sample.forcefield import ForceField, forcefield_target
            if "params_file" in section:
                with open(section["params_file"]) as f:
                    pd = yaml.safe_load(f)
            else:
                pd = section["params"]
            ke = section.get("coulomb_const", pd.get("coulomb_const", 1.0))
            # the run's dtype, f32 below f64 (the JAX package's float64
            # default is float32 on a device without x64)
            ff_dtype = (torch.float64 if self.dtype == torch.float64
                        else torch.float32)
            ff = ForceField.from_dict(pd, dtype=ff_dtype, device=self.device,
                                      ke=float(ke))
            t = forcefield_target(ff, kBT=kBT, e_cap=e_cap)
            n_atoms = ff.n_atoms
            # the dihedral observables of the sample modes (_ff_extras)
            self._ff, self._ff_params, self._ff_kBT = ff, pd, kBT
        else:
            raise ValueError(f"unknown target type {ttype!r}")
        return t, n_atoms

    def sample(self):
        """``mode: sample``: writes the algo's npz and prints its one-line
        summary (``driver.py:1150-1282``)."""
        sec = self.args["sampling"]
        algo_name = str(sec.get("algo", "smc")).lower()
        target, n_atoms = self._build_pos_target(sec["target"])
        P = int(sec.get("n_particles", 1024))
        box = float(sec["target"].get("box", 1e3))
        r_cut = float(sec["target"].get("r_cut", 1e2))
        n_pad = n_atoms
        if self.atom_axis > 1:
            # atom-sharded sampling (driver.py:1174-1202): the chain axis
            # holds every particle, the densities split the atoms
            if algo_name not in ("smc", "ais", "remc", "ti"):
                raise NotImplementedError(
                    f"sampling.algo={algo_name!r} with parallel.atom_axis > 1"
                    " — atom-sharded sampling supports smc | ais | remc | ti")
            from ..sample.sharded import make_sample_fns
            n_chain = self.mesh.shape["data"]
            if P % n_chain:
                raise ValueError(
                    f"sampling.n_particles={P} must be divisible by the "
                    f"chain axis ({n_chain} = devices / atom_axis "
                    f"{self.atom_axis})")
            propose_z, log_q0, log_p, n_pad = make_sample_fns(
                self.params, self.flow_cfg, target, n_atoms, box, r_cut,
                mesh=self.mesh)
        else:
            # the pushforward density needs the TRUE log-det (see the JAX
            # driver)
            cfg = dataclasses.replace(self.flow_cfg, exact_ldj=True)
            propose_z, log_q0, log_p = flow_densities(
                self.params, cfg, target, n_atoms, box, r_cut)
        # over several processes the particles split over the chain axis
        # for the densities' flow work (driver.py:1229-1243); the sampler
        # runs whole on every rank, from the same generators
        propose_z, log_q0, log_p = (mesh_lib.split_rows(f, self.mesh)
                                    for f in (propose_z, log_q0, log_p))
        if algo_name == "remc":
            return self._sample_remc(sec, propose_z, log_q0, log_p, P,
                                     n_atoms, n_pad)
        if algo_name in ("hmc", "nuts", "mala"):
            return self._sample_mcmc(algo_name, sec, propose_z, log_p, P,
                                     n_atoms)
        if algo_name == "ti":
            return self._sample_ti(sec, propose_z, log_q0, log_p, P, n_atoms,
                                   n_pad)
        if algo_name not in ("smc", "ais"):
            raise ValueError(
                f"sampling.algo={algo_name!r}; expected one of "
                "smc | ais | remc | hmc | nuts | mala | ti")
        return self._run_smc_ais(sec, algo_name, propose_z, log_q0, log_p, P,
                                 n_atoms, n_pad)

    def _latents(self, gen, P, n_atoms):
        kw = dict(generator=gen, dtype=self.dtype, device=self.device)
        nf = self.node_nf
        return {"h": torch.randn((P, n_atoms, nf), **kw),
                "g": torch.randn((P, n_atoms, nf), **kw),
                "pos": torch.randn((P, n_atoms, 3), **kw),
                "vel": torch.randn((P, n_atoms, 3), **kw)}

    def _run_smc_ais(self, sec, algo_name, propose_z, log_q0, log_p, P,
                     n_atoms, n_pad):
        """The SMC/AIS anneal and its outputs; the particles carry ``n_pad``
        atoms, the outputs are trimmed to ``n_atoms``."""
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
        # truncating neighbor formats: a tracked flow forward on (at most
        # 256 of) the particles at every anneal stage
        # (driver.py:1300-1307); the exact formats skip it
        track = self._capacity_can_truncate()
        if track:
            knobs["stage_fn"] = self._overflow_stage_fn(sec)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 31)
        n_retries = 0
        chunk = int(sec.get("chunk_temps", 0))
        ckpt_every = int(sec.get("checkpoint_every", 0))
        if chunk > 0 or ckpt_every > 0:
            if algo_name != "smc":
                raise NotImplementedError(
                    "sampling.chunk_temps / checkpoint_every support "
                    "algo: smc (ais carries per-particle weights across "
                    "every stage — chunk the SMC variant instead)")
            res, n_retries = self._run_smc_chunked(
                sec, gen, propose_z, P, n_pad, knobs, chunk or ckpt_every,
                ckpt_every)
        else:
            x0 = propose_z(self._latents(gen, P, n_pad))
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
        # trim the atom padding (driver.py:1351): masked noise, not samples
        parts = {k: _host(v[:, :n_atoms]) for k, v in res.particles.items()}
        # the per-stage truncation counts, read once (driver.py:1355-1366)
        if track and res.stage_metric_history is not None:
            nbr_overflow = int(res.stage_metric_history.sum())
            if nbr_overflow:
                eprint(f"WARNING: {nbr_overflow} neighbor slots truncated "
                       f"across the anneal stages (see the nbr_overflow "
                       f"column in sampling.metrics_csv) — raise "
                       f"dynamics.nbr_capacity/cell_capacity", flush=True)
        # force-field targets: dihedrals and importance-weighted phi/psi
        # profiles
        lw = _host(res.log_weights)
        w = np.exp(lw - lw.max())
        extra_out = self._ff_extras(res.particles["pos"], w / w.sum(), sec)
        self._savez(out_path, pos=parts["pos"], vel=parts["vel"], h=parts["h"],
                 g=parts["g"], log_weights=_host(res.log_weights),
                 log_Z=_host(res.log_Z), ess_history=_host(res.ess_history),
                 **({"beta_history": _host(res.beta_history)}
                    if res.beta_history is not None else {}),
                 **extra_out)
        print(f"sampled {P} particles -> {out_path}  "
              f"log_Z={float(res.log_Z):.3f}  final_ESS={ess:.1f}  "
              f"accept={float(res.accept_history[-1]):.2f}"
              + (f"  retries={n_retries}" if n_retries else ""), flush=True)
        self._log_sample_stages(sec, res, n_retries)
        return res

    def _overflow_stage_fn(self, sec, max_check=256):
        """The SMC/AIS ``stage_fn`` and REMC's per-round probe
        (``driver.py:1397-1427``): ``particles -> truncated-slot count``, a
        tracked flow forward without a graph on the first ``min(max_check,
        P)`` particles in the run's dtype, in the sampling target's ``box``
        (default 1e3) and ``r_cut`` (default 1e2). The count stays on the
        device (an int tensor); nothing is read on the host."""
        cfg_t = dataclasses.replace(self.flow_cfg, track_overflow=True)
        box = float(sec["target"].get("box", 1e3))
        r_cut = float(sec["target"].get("r_cut", 1e2))
        params, dtype = self.params, self.dtype

        @torch.no_grad()
        def stage_fn(x):
            n = min(max_check, x["pos"].shape[0])
            n_atoms = x["pos"].shape[1]
            dev = x["pos"].device
            sysb = System(
                h=x["h"][:n].to(dtype), g=x["g"][:n].to(dtype),
                pos=x["pos"][:n].to(dtype), vel=x["vel"][:n].to(dtype),
                mask=torch.ones((n, n_atoms), dtype=torch.bool, device=dev),
                box=torch.full((n, 3), box, dtype=dtype, device=dev),
                r_cut=torch.full((n,), r_cut, dtype=dtype, device=dev))
            _, _, ovf = forward_core(params, cfg_t, sysb)
            return ovf

        return stage_fn

    # -- chunked, resumable SMC (driver.py:1431-1586) ----------------------

    def _run_smc_chunked(self, sec, gen, propose_z, P, n_atoms, knobs, chunk,
                         ckpt_every):
        """The SMC anneal as segments of at most ``chunk`` temperatures
        (``sample/smc.py: smc_segments``), each run through the retrying
        runner; with ``sampling.checkpoint_every`` the state goes to
        ``sampling.state_file`` (default ``<output>.state.npz``) every that
        many stages, a killed run resumes from it (``sampling.resume``,
        default true) and a completed run removes it. Equal bit for bit to
        the monolithic run of the same seed: the latents are drawn from
        ``gen`` also on a resume, so the stage generators are the same.
        Returns ``(result, retries)``."""
        from ..sample.smc import smc_segments

        n_temps = knobs["n_temps"]
        run_segment, retries = self._retrying_runner()
        state_file = sec.get("state_file") or (
            str(sec.get("output", "samples.npz")) + ".state.npz")
        start_stage, init_state, init_hists = 0, None, None
        if ckpt_every and sec.get("resume", True) and \
                os.path.exists(state_file):
            start_stage, init_state, init_hists = \
                self._load_sample_state(state_file)
            eprint(f"resuming sampling at stage {start_stage} from "
                   f"{state_file}", flush=True)
        saved = {"last": start_stage}

        def on_segment(j, state, hists):
            if not ckpt_every or j == n_temps:
                return
            if j // ckpt_every > saved["last"] // ckpt_every:
                self._save_sample_state(state_file, j, state, hists)
                saved["last"] = j

        z = self._latents(gen, P, n_atoms)
        x0 = None if init_state is not None else run_segment(propose_z, z)
        res = smc_segments(gen, x0, chunk_temps=chunk,
                           run_segment=run_segment, on_segment=on_segment,
                           start_stage=start_stage, init_state=init_state,
                           init_hists=init_hists, **knobs)
        if ckpt_every and self.is_main and os.path.exists(state_file):
            os.remove(state_file)       # completed runs must not resume
        if retries["n"]:
            eprint(f"sampling survived {retries['n']} device retr"
                   f"{'y' if retries['n'] == 1 else 'ies'}", flush=True)
        return res, retries["n"]

    def _retrying_runner(self):
        """``(run, counter)``: an executor that retries a call ONCE, after
        5 s, when it fails with an error whose text holds ``UNAVAILABLE``
        (the JAX package's transient device fault), counting the retries.
        On the card it synchronizes before returning, so that a fault of
        the call surfaces inside the ``try``. It retries nothing else: a
        CUDA launch or illegal-address error is sticky for the process, so
        a retry could not clear it."""
        counter = {"n": 0}

        def run(f, *a):
            for attempt in (0, 1):
                try:
                    out = f(*a)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    return out
                except Exception as e:
                    if "UNAVAILABLE" not in str(e) or attempt:
                        raise
                    counter["n"] += 1
                    eprint(f"device UNAVAILABLE mid-segment ({e}); "
                           "retrying in 5 s", flush=True)
                    time.sleep(5.0)

        return run, counter

    def _save_sample_state(self, path, stage, state, hists):
        """The SMC carry and histories, in the JAX driver's npz keys,
        written atomically (by rank 0)."""
        if not self.is_main:
            return
        (x, log_w, log_z, beta, eps, lq0, lp, glq0, glp) = state
        out = {"stage": np.asarray(stage), "log_w": _host(log_w),
               "log_z": _host(log_z), "beta": _host(beta),
               "eps": _host(eps), "lq0": _host(lq0), "lp": _host(lp)}
        for k, v in x.items():
            out[f"x_{k}"] = _host(v)
        if glq0 is not None:
            for k, v in glq0.items():
                out[f"gq_{k}"] = _host(v)
            for k, v in glp.items():
                out[f"gp_{k}"] = _host(v)
        # four histories, and a fifth (the stage metric) with a stage_fn
        names = ("ess", "acc", "betah", "steph", "metric")[:len(hists[0])]
        for i, name in enumerate(names):
            out[f"hist_{name}"] = np.concatenate([_host(h[i]) for h in hists])
        tmp = path + ".tmp.npz"     # .npz suffix: savez must not append one
        np.savez(tmp, **out)
        os.replace(tmp, path)

    def _load_sample_state(self, path):
        """``(stage, state, hists)`` of a state file of either package, on
        the driver's device in its dtype."""
        t = lambda a: torch.from_numpy(np.array(a)).to(self.device,
                                                        self.dtype)
        with np.load(path) as z:
            x = {k[2:]: t(z[k]) for k in z.files if k.startswith("x_")}
            glq0 = {k[3:]: t(z[k]) for k in z.files
                    if k.startswith("gq_")} or None
            glp = {k[3:]: t(z[k]) for k in z.files
                   if k.startswith("gp_")} or None
            state = (x, t(z["log_w"]), t(z["log_z"]), t(z["beta"]),
                     t(z["eps"]), t(z["lq0"]), t(z["lp"]), glq0, glp)
            hists = [tuple(t(z[f"hist_{n}"])
                           for n in ("ess", "acc", "betah", "steph"))
                     + ((torch.from_numpy(z["hist_metric"]).to(self.device),)
                        if "hist_metric" in z.files else ())]
            return int(z["stage"]), state, hists

    def _log_sample_stages(self, sec, res, n_retries=0):
        """One ``sampling.metrics_csv`` row per temperature (stage, beta,
        ESS, accept; ``log_Z`` and the retries on the last row), in the JAX
        driver's columns; ``nbr_overflow`` is each stage's own truncation
        count with a truncating neighbor format, else empty."""
        path = sec.get("metrics_csv")
        if not path:
            return
        logger = self._logger(path)
        ess_h = _host(res.ess_history)
        acc_h = _host(res.accept_history)
        beta_h = (_host(res.beta_history)
                  if res.beta_history is not None else None)
        ovf_h = (_host(res.stage_metric_history)
                 if res.stage_metric_history is not None else None)
        for i in range(len(ess_h)):
            last = i == len(ess_h) - 1
            logger.log(stage=i,
                       beta=(float(beta_h[i]) if beta_h is not None else ""),
                       ess=float(ess_h[i]),
                       accept=float(acc_h[i]) if i < len(acc_h) else "",
                       log_Z=float(res.log_Z) if last else "",
                       retries=n_retries if last else "",
                       nbr_overflow=(int(ovf_h[i]) if ovf_h is not None
                                     else ""))
        logger.close()

    def _ff_extras(self, pos, weights, sec):
        """Dihedral observables and phi/psi free-energy profiles of a
        force-field target (``driver.py:1619-1638``): ``pos [n, N, 3]`` (a
        tensor, the dihedrals computed on its device), ``weights [n]`` or
        None. Empty for other targets."""
        ff = getattr(self, "_ff", None)
        if ff is None:
            return {}
        from ..sample.forcefield import dihedral_angles, free_energy_profile

        ang = _host(dihedral_angles(ff, torch.as_tensor(pos,
                                                        device=ff.sigma.device)))
        extra_out = {"dihedrals": ang}
        for name in ("phi", "psi"):
            i = self._ff_params.get(f"{name}_torsion_index")
            if i is not None:
                c, F = free_energy_profile(
                    ang[:, int(i)], self._ff_kBT,
                    bins=int(sec.get("fe_bins", 36)), weights=weights)
                extra_out[f"{name}_centers"] = c
                extra_out[f"{name}_free_energy"] = F
        return extra_out

    def _sample_mcmc(self, algo, sec, propose_z, log_p, C, n_atoms):
        """``sampling.algo: hmc | nuts | mala`` (``driver.py:1640-1727``):
        plain MCMC on the target density (``log_p``: the target plus the
        auxiliary Gaussians; the flow only draws the chain starts, one
        reverse). Keys ``n_particles`` (chains), ``n_samples`` (kept
        sweeps), ``n_warmup``, ``thin``, ``step_size``; HMC ``n_leapfrog``
        and ``adapt_step`` / ``target_accept`` (dual averaging over
        ``n_warmup`` steps in place of the warmup sweeps); NUTS
        ``max_depth`` (its state one flat vector a chain, the leaves in
        sorted key order). The npz holds ``[n_samples * C]`` unweighted
        draws."""
        from ..sample import mcmc as mcmc_lib

        n_samples = int(sec.get("n_samples", 100))
        n_warmup = int(sec.get("n_warmup", 50))
        thin = int(sec.get("thin", 1))
        step_size = float(sec.get("step_size", 0.02))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 31)
        x0 = propose_z(self._latents(gen, C, n_atoms))
        if algo == "hmc":
            n_leapfrog = int(sec.get("n_leapfrog", 5))
            if bool(sec.get("adapt_step", False)):
                eps, x0 = mcmc_lib.dual_averaging_warmup(
                    gen, x0, log_p, n_adapt=max(n_warmup, 1),
                    n_leapfrog=n_leapfrog,
                    target_accept=float(sec.get("target_accept", 0.65)),
                    init_step_size=step_size)
                step_size = float(eps)
                n_warmup = 0
            res = mcmc_lib.run_hmc(gen, x0, log_p, n_samples=n_samples,
                                   n_warmup=n_warmup, step_size=step_size,
                                   n_leapfrog=n_leapfrog, thin=thin)
            samples = res.samples
            extra_info = {"accept_rate": _host(res.accept_rate),
                          "step_size": step_size}
        elif algo == "mala":
            res = mcmc_lib.run_mala(gen, x0, log_p, n_samples=n_samples,
                                    n_warmup=n_warmup, step_size=step_size,
                                    thin=thin)
            samples = res.samples
            extra_info = {"accept_rate": _host(res.accept_rate),
                          "step_size": step_size}
        else:
            from ..sample.nuts import run_nuts
            keys = sorted(x0)
            sizes = [x0[k][0].numel() for k in keys]
            shapes = [tuple(x0[k].shape[1:]) for k in keys]

            def unravel(v):
                parts = torch.split(v, sizes, dim=-1)
                return {k: p.reshape(v.shape[:-1] + s)
                        for k, p, s in zip(keys, parts, shapes)}

            flat0 = torch.cat([x0[k].reshape(C, -1) for k in keys], dim=1)
            res = run_nuts(gen, flat0, lambda v: log_p(unravel(v)),
                           n_samples=n_samples, n_warmup=n_warmup,
                           step_size=step_size,
                           max_depth=int(sec.get("max_depth", 8)))
            samples = unravel(res.samples)
            extra_info = {"mean_depth": float(res.mean_depth),
                          "divergence_rate": float(res.divergence_rate)}
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in samples.items()}
        out_path = sec.get("output", "samples.npz")
        extra_out = self._ff_extras(flat["pos"], None, sec)
        self._savez(out_path, algo=algo,
                    **{k: _host(v) for k, v in flat.items()},
                 **extra_info, **extra_out)
        stats = "  ".join(f"{k}={float(np.asarray(v)):.3g}"
                          for k, v in extra_info.items())
        print(f"sampled {flat['pos'].shape[0]} draws "
              f"({n_samples} sweeps x {C} chains, {algo}) -> {out_path}"
              f"  {stats}", flush=True)
        csv_path = sec.get("metrics_csv")
        if csv_path:
            logger = self._logger(csv_path)
            logger.log(algo=algo, n_chains=C, n_samples=n_samples,
                       **{k: float(np.asarray(v))
                          for k, v in extra_info.items()})
            logger.close()
        return samples

    def _sample_ti(self, sec, propose_z, log_q0, log_p, C, n_atoms, n_pad):
        """``sampling.algo: ti`` (``driver.py:1729-1810``), thermodynamic
        integration along the flow bridge from one flow draw of ``C``
        chains, every dispatch through the retrying runner. Keys
        ``ti_nodes`` (25), ``beta_min``, ``n_samples`` (sweeps a node,
        400), ``n_warmup`` (150), ``step_size`` (0.08), ``step_size_final``,
        ``n_leapfrog``, ``adapt_step`` / ``target_accept``,
        ``precondition``, ``chunk_steps``. The npz holds the final beta=1
        chains and the node table; ``metrics_csv`` one row a node."""
        from ..sample.ti import thermodynamic_integration

        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 37)
        x0 = propose_z(self._latents(gen, C, n_pad))
        run, retries = self._retrying_runner()
        res = thermodynamic_integration(
            gen, x0, log_q0=log_q0, log_p=log_p,
            n_nodes=int(sec.get("ti_nodes", 25)),
            beta_min=float(sec.get("beta_min", 0.01)),
            n_steps=int(sec.get("n_samples", 400)),
            n_warmup=int(sec.get("n_warmup", 150)),
            step_size=float(sec.get("step_size", 0.08)),
            step_size_final=(None if sec.get("step_size_final") is None
                             else float(sec["step_size_final"])),
            n_leapfrog=int(sec.get("n_leapfrog", 5)),
            adapt_step=bool(sec.get("adapt_step", False)),
            target_accept=float(sec.get("target_accept", 0.65)),
            precondition=bool(sec.get("precondition", False)),
            chunk_steps=(None if sec.get("chunk_steps") is None
                         else int(sec["chunk_steps"])),
            run_node=run)
        flat = {k: _host(v[:, :n_atoms]) for k, v in res.x.items()}
        out_path = sec.get("output", "samples.npz")
        extra_out = self._ff_extras(res.x["pos"], None, sec)
        bet, mean, se_n, acc = (_host(t) for t in (
            res.betas, res.node_mean, res.node_se, res.accept))
        self._savez(out_path, algo="ti", log_Z=float(res.log_Z),
                 log_Z_se=float(res.se), quad_err=float(res.quad_err),
                 betas=bet, node_mean=mean, node_se=se_n, node_accept=acc,
                 **flat, **extra_out)
        print(f"TI over {len(bet)} nodes x {C} chains"
              f" -> {out_path}  log_Z={float(res.log_Z):.3f}"
              f" +- {float(res.se):.3f} (quad_err {float(res.quad_err):.3f},"
              f" mean accept {float(acc.mean()):.2f},"
              f" retries {retries['n']})", flush=True)
        csv_path = sec.get("metrics_csv")
        if csv_path:
            logger = self._logger(csv_path)
            for i in range(len(bet)):
                logger.log(algo="ti", node=i, beta=float(bet[i]),
                           integrand=float(mean[i]),
                           integrand_se=float(se_n[i]),
                           accept=float(acc[i]))
            logger.close()
        return res

    def _remc_ladder(self, sec):
        """``sampling.betas``, else ``[0] + geomspace(beta_hot, 1,
        n_temps - 1)`` (``beta_min <= 0``, the default) or
        ``geomspace(beta_min, 1, n_temps)``, the last slot pinned to 1
        (``driver.py:1841-1866``)."""
        betas = sec.get("betas")
        if betas is not None:
            return np.asarray([float(b) for b in betas])
        beta_min = float(sec.get("beta_min", 0.0))
        n_temps = int(sec.get("n_temps", 6))
        if n_temps < 2:
            raise ValueError("sampling.n_temps must be >= 2 for remc "
                             "(a ladder needs a base and a target slot)")
        if beta_min <= 0.0:
            betas = np.concatenate([
                np.zeros((1,)),
                np.geomspace(float(sec.get("beta_hot", 0.05)), 1.0,
                             n_temps - 1)])
        else:
            betas = np.geomspace(beta_min, 1.0, n_temps)
        betas[-1] = 1.0
        return betas

    def _sample_remc(self, sec, propose_z, log_q0, log_p, M, n_atoms, n_pad):
        """``sampling.algo: remc`` (``driver.py:1812-2077``): flow-bridged
        parallel tempering over ``_remc_ladder``'s slots x ``M`` chains,
        independent flow draws for every slot from ONE ``K*M`` reverse, a
        per-slot ``step_size`` list or one step, ``n_rounds`` and
        ``discard_rounds`` (default half), ``chunk_rounds`` segments
        through the retrying runner; with ``mbar: true`` MBAR over the
        final ladder and ``mbar_pool_rounds`` thinned kept beta=1 rounds
        (``mbar_iters``, ``mbar_blocks`` column-block replicates). The npz
        holds the kept beta=1 rounds ``[R - discard, M, ...]``, the swap
        and HMC acceptances, the ladder and the MBAR results;
        ``metrics_csv`` one row a slot."""
        from ..sample.mcmc import tree_map
        from ..sample.remc import remc, remc_segments

        # truncating neighbor formats: the overflow probe once a round over
        # the flattened replicas (driver.py:1832-1834)
        track = self._capacity_can_truncate()
        betas = self._remc_ladder(sec)
        K = len(betas)
        step_size = sec.get("step_size", 0.02)
        if isinstance(step_size, (list, tuple)):
            step_size = [float(s) for s in step_size]
        else:
            step_size = float(step_size)
        n_rounds = int(sec.get("n_rounds", 100))
        discard = int(sec.get("discard_rounds", n_rounds // 2))
        knobs = dict(log_p=log_p, log_q0=log_q0, betas=betas,
                     n_rounds=n_rounds,
                     mcmc_steps=int(sec.get("mcmc_steps", 1)),
                     step_size=step_size,
                     n_leapfrog=int(sec.get("n_leapfrog", 5)),
                     stage_fn=self._overflow_stage_fn(sec) if track else None)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 31)
        # INDEPENDENT flow draws per slot, one K*M reverse reshaped: swaps
        # act within a chain column, so a tiled bad draw would wedge its
        # column's beta=1 slot
        z = self._latents(gen, K * M, n_pad)

        def draw(z):
            return tree_map(lambda a: a.reshape((K, M) + a.shape[1:]),
                            propose_z(z))

        n_retries = 0
        chunk = int(sec.get("chunk_rounds", 0))
        if chunk > 0:
            run_segment, retries = self._retrying_runner()
            x0 = run_segment(draw, z)
            res = remc_segments(gen, x0, chunk_rounds=chunk,
                                run_segment=run_segment, **knobs)
            n_retries = retries["n"]
        else:
            res = remc(gen, draw(z), **knobs)
        mbar_out = self._remc_mbar(sec, res, log_p, log_q0, M, discard)
        nbr_overflow = ""
        if track and res.round_metric_history is not None:
            nbr_overflow = int(res.round_metric_history.sum())
            if nbr_overflow:
                eprint(f"WARNING: {nbr_overflow} neighbor slots truncated "
                       f"across the REMC rounds — raise "
                       f"dynamics.nbr_capacity/cell_capacity", flush=True)

        out_path = sec.get("output", "samples.npz")
        # kept rounds, the atom padding trimmed (driver.py:2032)
        keep = {k: v[discard:, :, :n_atoms] for k, v in res.samples.items()}
        extra_out = self._ff_extras(
            keep["pos"].reshape((-1,) + keep["pos"].shape[2:]), None, sec)
        sa, acc, bet = (_host(t) for t in (res.swap_accept, res.accept,
                                            res.betas))
        self._savez(out_path, **{k: _host(v) for k, v in keep.items()},
                 swap_accept=sa, accept=acc, betas=bet, **mbar_out,
                 **extra_out)
        mb = (f"  mbar_log_Z={mbar_out['mbar_log_Z']:.3f}"
              if mbar_out else "")
        if "mbar_log_Z_se" in mbar_out:
            mb += f"+-{mbar_out['mbar_log_Z_se']:.3f}"
        retr = f"  retries={n_retries}" if n_retries else ""
        print(f"remc: {n_rounds} rounds x {M} chains x {K} temps -> "
              f"{out_path}  kept {keep['pos'].shape[0]} rounds  "
              f"swap_accept=[{sa.min():.2f},{sa.max():.2f}]  "
              f"hmc_accept={float(acc[-1]):.2f}{mb}{retr}", flush=True)
        csv_path = sec.get("metrics_csv")
        if csv_path:
            # one row per slot: beta, HMC accept, the swap accept with the
            # next slot; MBAR and the retries on the last
            logger = self._logger(csv_path)
            for k in range(K):
                logger.log(slot=k, beta=float(bet[k]),
                           hmc_accept=float(acc[k]),
                           swap_accept=(float(sa[k]) if k < K - 1 else ""),
                           mbar_log_Z=(mbar_out.get("mbar_log_Z", "")
                                       if k == K - 1 else ""),
                           retries=(n_retries if k == K - 1 else ""),
                           nbr_overflow=(nbr_overflow if k == K - 1
                                         else ""))
            logger.close()
        return res

    @torch.no_grad()
    def _remc_mbar(self, sec, res, log_p, log_q0, M, discard):
        """The MBAR block of ``_sample_remc`` (``driver.py:1929-2018``):
        the final ladder's ``K*M`` states, then ``mbar_pool_rounds``
        (default 5) kept beta=1 rounds from ``[discard, R-2]`` (round R-1's
        beta=1 slot is ``x_final``'s), evaluated under the bridged family;
        ``mbar_iters`` (1000) iterations; ``mbar_blocks`` (4) column-block
        replicates for the error bar. Empty without ``mbar: true``."""
        if not sec.get("mbar"):
            return {}
        from ..sample.mbar import (bridge_potentials, mbar, mbar_block_log_z,
                                   mbar_from_remc)
        from ..sample.mcmc import tree_map

        u_kn, counts = mbar_from_remc(res, log_p, log_q0)
        K = int(res.betas.shape[0])
        # provenance of every pooled sample: x_final flattens [K, M] row
        # major, so sample n is state n // M, chain column n % M
        states = np.repeat(np.arange(K), M)
        columns = np.tile(np.arange(M), K)
        n_pool = int(sec.get("mbar_pool_rounds", 5))
        R = int(res.samples["pos"].shape[0])
        if n_pool > 0 and R - 1 > discard:
            idx = np.unique(np.linspace(discard, R - 2, n_pool, dtype=int))
            sel = torch.as_tensor(idx, device=res.betas.device)
            pooled = tree_map(lambda a: a[sel].reshape((-1,) + a.shape[2:]),
                              res.samples)
            lp2, lq2 = log_p(pooled), log_q0(pooled)
            u_kn = torch.cat([u_kn, bridge_potentials(res.betas, lq2, lp2)],
                             dim=1)
            counts = counts.clone()
            counts[-1] += lp2.shape[0]
            states = np.concatenate([states,
                                     np.full(int(lp2.shape[0]), K - 1)])
            columns = np.concatenate(
                [columns, np.tile(np.arange(M), int(lp2.shape[0]) // M)])
        n_it = int(sec.get("mbar_iters", 1000))
        mres = mbar(u_kn, counts, n_iter=n_it)
        out = {"mbar_f": _host(mres.f),
               "mbar_log_Z": -float(mres.f[-1] - mres.f[0]),
               "mbar_converged": float(mres.converged)}
        n_blocks = int(sec.get("mbar_blocks", 4))
        if n_blocks > 1 and M >= n_blocks:
            blocks = mbar_block_log_z(u_kn, states, columns, K,
                                      n_blocks=n_blocks, n_iter=n_it)
            out["mbar_log_Z_blocks"] = blocks
            out["mbar_log_Z_se"] = float(blocks.std(ddof=1)
                                         / np.sqrt(len(blocks)))
        return out

    # ------------------------------------------------------------------
    # generate
    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, out_dir="."):
        """Reverse the flow on the first latent frame (``driver.py:1110-
        1151``): write ``h.out`` and ``test_out.xyz`` of the real atoms,
        then print whether ``reverse(forward(out)) == out`` holds for the
        positions and the features (atol 1e-8 in float64, 1e-4 otherwise;
        ``forward``'s dequantization noise from a generator seeded 99)."""
        cfg = self.flow_cfg
        batch = next(iter(self.train_loader))
        if self.atom_axis > 1:
            # the sharded flow (driver.py:1114-1120)
            from ..flow.sharded import sharded_forward, sharded_reverse
            rev = lambda sys: sharded_reverse(self.mesh, self.params, cfg,
                                              sys)
            fwd = lambda sys, gen: sharded_forward(self.mesh, self.params,
                                                   cfg, sys, gen=gen)
        else:
            rev = lambda sys: reverse(self.params, cfg, sys)
            fwd = lambda sys, gen: forward(self.params, cfg, sys, gen=gen)
        out = rev(batch)
        mask = out.mask[0].cpu().numpy()
        if self.is_main:
            np.savetxt(os.path.join(out_dir, "h.out"),
                       _host(out.h[0])[mask], delimiter=" ")
            write_xyz(os.path.join(out_dir, "test_out.xyz"),
                      _host(out.pos[0])[mask])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(99)
        data_, _ = fwd(out, gen)
        back = rev(data_)
        atol = 1e-8 if self.dtype == torch.float64 else 1e-4
        print(bool(torch.allclose(back.pos, out.pos, atol=atol)), flush=True)
        print(bool(torch.allclose(back.h, out.h, atol=atol)), flush=True)
        return out

    def __call__(self, input_path):
        if self.is_main:
            return self._run(input_path)
        # only rank 0 prints (driver.py's is_main)
        import contextlib
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), \
                contextlib.redirect_stderr(null):
            return self._run(input_path)

    def _run(self, input_path):
        self.setup(input_path)
        if self.mode == "train":
            return self.train()
        if self.mode == "generate":
            return self.generate()
        if self.mode == "sample":
            return self.sample()
        return self.dataset
