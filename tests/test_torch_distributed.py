"""The process-group form (``parallel/collectives.py:GroupAxis``,
``parallel/mesh.py``) over gloo with 2 spawned processes, against the
in-process form and against one process.

- The collectives and their gradients (a ring body, ``split``, ``gather``,
  ``psum``) equal ``VirtualAxis(2)``'s.
- The atom-sharded NLL's parameter gradient, summed over the ranks, equals
  the in-process one and the dense one: a ``psum`` whose backward
  all-reduced the cotangent, or a mean over ranks, would be off by 2. The
  data-parallel NLL gradient (two ranks, a batch each) equals one process's
  on the whole batch.
- The driver: a two-rank data-parallel ``train`` run gives the losses and
  the checkpoint of one process on the same global batch, and a two-rank
  atom-sharded run those of the in-process form; two-rank flow-VI (the
  particles split over the ranks) and SMC and REMC with MBAR (the
  densities' particles split over the chain axis) give one process's
  losses, checkpoint and outputs, and a two-rank atom-sharded SMC (6
  atoms padded to 8, the ring over the ranks) the in-process form's.

Tolerance: float64 round-off, 1e-10. Each spawned pair has a timeout; this
file imports no JAX (the workers run it as a script).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow.integrators import FlowConfig, forward, init_flow
from enflow_tpu_torch.flow.loss import alchemical_nll
from enflow_tpu_torch.flow.sharded import make_sharded_nll
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.parallel import mesh as mesh_lib
from enflow_tpu_torch.parallel.pairwise import ring_alchemical_lj
from enflow_tpu_torch.utils.jax_params import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10
B, N, NF = 4, 8, 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(case, out_dir, timeout=240):
    """Run ``case`` in 2 gloo ranks (this file as a script); returns rank
    0's stdout."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "COORDINATOR_", "NUM_PROCESSES",
                                "PROCESS_ID", "LOCAL_RANK"))}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(out_dir)], cwd=str(out_dir),
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs[0][0]


# ---------------------------------------------------------------------------
# the cases, each run by both ranks and, in one process, by the test
# ---------------------------------------------------------------------------

def _ring_case(ax):
    """A ring body, ``gather``, ``psum`` and their gradient in ``x``."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, N, 3)), requires_grad=True)
    m = torch.ones((3, N), dtype=torch.bool)
    m[2, 5:] = False
    blk = ax.split(x)
    e = ax.collapse(ring_alchemical_lj(blk, ax.split(m), 0.1, ax))
    y = ax.gather(blk * blk.sum(dim=(1, 2), keepdim=True))
    s = ax.collapse(ax.psum((blk ** 3).sum(dim=(1, 2))))
    g, = torch.autograd.grad(e.sum() + (y * y).sum() + s.sum(), x)
    return {"e": e.detach().numpy(), "y": y.detach().numpy(),
            "s": s.detach().numpy(), "g": g.numpy()}


def _flow():
    cfg = FlowConfig(n_iter=2, dt=0.05, egcl=EGCLConfig(NF, 8),
                     nbr_mode="dense")
    params = init_flow(torch.Generator().manual_seed(0), cfg, torch.float64,
                       "cpu")
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    mask = np.ones((B, N), bool)
    mask[-1, 5:] = False
    t = lambda a: torch.from_numpy(a * mask[..., None])
    sys_ = System(h=t(np.eye(NF)[rng.integers(0, NF, (B, N))]),
                  g=t(rng.normal(size=(B, N, NF))),
                  pos=t(rng.uniform(-2, 2, (B, N, 3))),
                  vel=t(0.3 * rng.normal(size=(B, N, 3))),
                  mask=torch.from_numpy(mask),
                  box=torch.full((B, 3), 20.0, dtype=torch.float64),
                  r_cut=torch.full((B,), 3.0, dtype=torch.float64))
    eps = torch.from_numpy(rng.normal(size=(B, N, NF)))
    return cfg, params, sys_, eps


def _grads(params, loss):
    """The parameters' gradient of ``loss``, summed over the ranks."""
    leaves, _ = tree_flatten(params)
    for p in leaves:
        p.grad = None
    loss.backward()
    mesh_lib.sum_grads(leaves)
    return np.concatenate([p.grad.reshape(-1).numpy() for p in leaves])


def _nll_case(mesh_atom, mesh_data):
    """The atom-sharded NLL over ``mesh_atom``; the data-parallel NLL with
    this process's rows of the batch over ``mesh_data``."""
    cfg, params, sys_, eps = _flow()
    loss = make_sharded_nll(mesh_atom, cfg, 1.2, 0.1)(params, sys_, eps=eps)
    out = {"atom_loss": loss.item(), "atom_grad": _grads(params, loss)}
    rows = mesh_lib.shard_batch(sys_, mesh_data)
    dx = mesh_data["data"]
    o, ldj = forward(params, cfg, rows, eps=eps[dx.index::dx.size])
    loss = alchemical_nll(o, ldj, 1.2, 0.1, data_axis=dx)
    out.update(data_loss=loss.item(), data_grad=_grads(params, loss))
    return out


def _write_xyz(path, n_frames=8, n_atoms=4):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(n_frames):
            f.write(f"{n_atoms}\nc\n")
            for a in range(n_atoms):
                x, y, z = rng.uniform(-3, 3, 3)
                f.write(f"{'COHN'[a % 4]} {x:.6f} {y:.6f} {z:.6f}\n")


def _train_yaml(d, name, batch_size, atom_axis=1):
    import yaml
    cfg = {"mode": "train", "units": {"time": "pico", "dist": "ang"},
           "precision": "float64", "seed": 1,
           "dataset": {"type": "xyz", "raw_file": str(d / "mols.xyz"),
                       "box": [10.0, 10.0, 10.0], "r_cut": 9.0,
                       "randomize_vel": True, "temp": 300},
           "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 1,
                        "nbr_mode": "all_pairs",
                        "checkpoint_path": str(d / f"{name}.cpt"),
                        "network": {"hidden_nf": 16}},
           "training": {"num_epochs": 2, "batch_size": batch_size,
                        "lr": 1e-3, "scheduler": False,
                        "loss": {"temp": 300, "softening": 0.5},
                        "log_interval": 1}}
    if atom_axis > 1:
        cfg["parallel"] = {"atom_axis": atom_axis}
    path = d / f"{name}.{os.getpid()}.yaml"     # one a rank: no race
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _vi_yaml(d, name):
    import yaml
    cfg = {"mode": "train", "units": {"time": "pico", "dist": "ang"},
           "precision": "float64", "seed": 4,
           "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 1,
                        "checkpoint_path": str(d / f"{name}.cpt"),
                        "nbr_mode": "all_pairs",
                        "network": {"hidden_nf": 8, "node_nf": 3}},
           "training": {"objective": "flow_vi", "num_epochs": 2,
                        "steps_per_epoch": 2, "n_particles": 8, "lr": 1e-3,
                        "scheduler": False, "log_interval": 1,
                        "target": {"type": "lj_cluster", "n_atoms": 4,
                                   "kBT": 2.0, "softening": 0.1,
                                   "e_cap": 500.0}}}
    path = d / f"{name}.{os.getpid()}.yaml"     # one a rank: no race
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _sample_yaml(d, name, algo, atom_axis=1):
    import yaml
    cfg = {"mode": "sample", "units": {"time": "pico", "dist": "ang"},
           "precision": "float64", "seed": 3,
           "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 0.1,
                        "nbr_mode": "all_pairs",
                        "network": {"hidden_nf": 8, "node_nf": 3}},
           "sampling": {"algo": algo, "n_particles": 8, "n_temps": 3,
                        "n_rounds": 3, "mbar": True, "mbar_pool_rounds": 2,
                        "mbar_iters": 50, "mcmc_steps": 1,
                        "step_size": 0.02, "n_leapfrog": 2,
                        "output": str(d / f"{name}.npz"),
                        "target": {"type": "lj_cluster", "n_atoms": 6,
                                   "kBT": 2.0, "softening": 0.1}}}
    if atom_axis > 1:
        cfg["parallel"] = {"atom_axis": atom_axis}
    path = d / f"{name}.{os.getpid()}.yaml"     # one a rank: no race
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _worker(case, out_dir):
    import torch.distributed as dist
    from enflow_tpu_torch.parallel.mesh import get_mesh
    from enflow_tpu_torch.train.driver import Main

    d = Path(out_dir)
    if case == "train":
        # Main joins the group from the environment
        Main(device="cpu")(_train_yaml(d, "dp", 2))
        Main(device="cpu")(_train_yaml(d, "atom2", 4, atom_axis=2))
    elif case == "sample":
        Main(device="cpu")(_vi_yaml(d, "vi"))
        for algo in ("smc", "remc"):
            Main(device="cpu")(_sample_yaml(d, algo, algo))
        Main(device="cpu")(_sample_yaml(d, "smc_atom2", "smc", atom_axis=2))
    else:
        assert mesh_lib.maybe_initialize_distributed("cpu")
        if case == "ring":
            res = _ring_case(get_mesh(("atom",))["atom"])
        else:
            res = _nll_case(get_mesh(("atom",)), get_mesh(("data",)))
        if dist.get_rank() == 0:
            np.savez(d / f"{case}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_group_collectives_equal_in_process(tmp_path):
    _spawn("ring", tmp_path)
    want = _ring_case(mesh_lib.get_mesh(("atom",), (2,),
                                        virtual_devices=2)["atom"])
    with np.load(tmp_path / "ring.npz") as got:
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_group_nll_gradients_equal_in_process_and_dense(tmp_path):
    _spawn("nll", tmp_path)
    want = _nll_case(mesh_lib.get_mesh(("atom",), (2,), virtual_devices=2),
                     mesh_lib.get_mesh(("data",)))
    cfg, params, sys_, eps = _flow()
    o, ldj = forward(params, cfg, sys_, eps=eps)
    dense_loss = alchemical_nll(o, ldj, 1.2, 0.1)
    dense = _grads(params, dense_loss)
    with np.load(tmp_path / "nll.npz") as got:
        for k in ("atom", "data"):
            np.testing.assert_allclose(got[f"{k}_loss"], want[f"{k}_loss"],
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got[f"{k}_loss"], dense_loss.item(),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got[f"{k}_grad"], want[f"{k}_grad"],
                                       rtol=1e-8, atol=TOL)
            np.testing.assert_allclose(got[f"{k}_grad"], dense, rtol=1e-8,
                                       atol=TOL)


def _losses(stdout):
    return [float(ln.split()[1]) for ln in stdout.splitlines()
            if ln[:1].isdigit()]


def test_two_rank_training_equals_one_process(tmp_path, capsys):
    from enflow_tpu_torch.train.checkpoint import load_checkpoint
    from enflow_tpu_torch.train.driver import Main

    _write_xyz(tmp_path / "mols.xyz")
    two = _losses(_spawn("train", tmp_path))
    ref = {}
    for name, kw in (("dp_ref", dict(batch_size=4)),
                     ("atom2_ref", dict(batch_size=4, atom_axis=2))):
        main = Main(device="cpu", virtual_devices=kw.get("atom_axis", 1))
        main(_train_yaml(tmp_path, name, **kw))
        ref[name] = main
    one = _losses(capsys.readouterr().out)
    assert len(two) == len(one) == 4
    np.testing.assert_allclose(two, one, rtol=TOL, atol=TOL)
    for name in ("dp", "atom2"):
        template = {"params": ref[f"{name}_ref"].params}
        a, _ = load_checkpoint(str(tmp_path / f"{name}.cpt"), template)
        b, _ = load_checkpoint(str(tmp_path / f"{name}_ref.cpt"), template)
        for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), rtol=TOL,
                                       atol=TOL, err_msg=name)



def test_two_rank_vi_and_sampling_equal_one_process(tmp_path, capsys):
    from enflow_tpu_torch.train.checkpoint import load_checkpoint
    from enflow_tpu_torch.train.driver import Main

    two = _losses(_spawn("sample", tmp_path))
    ref = tmp_path / "ref"
    ref.mkdir()
    main = Main(device="cpu")
    main(_vi_yaml(ref, "vi"))
    one = _losses(capsys.readouterr().out)
    assert len(two) == len(one) == 2
    np.testing.assert_allclose(two, one, rtol=TOL, atol=TOL)
    template = {"params": main.params}
    a, _ = load_checkpoint(str(tmp_path / "vi.cpt"), template)
    b, _ = load_checkpoint(str(ref / "vi.cpt"), template)
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=TOL, atol=TOL)
    Main(device="cpu", virtual_devices=2)(
        _sample_yaml(ref, "smc_atom2", "smc", atom_axis=2))
    for algo in ("smc", "remc"):
        Main(device="cpu")(_sample_yaml(ref, algo, algo))
    for algo in ("smc", "remc", "smc_atom2"):
        with np.load(tmp_path / f"{algo}.npz") as got, \
                np.load(ref / f"{algo}.npz") as want:
            assert set(got.files) == set(want.files)
            for k in want.files:
                if want[k].dtype.kind == "f":
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-8,
                                               atol=1e-8, err_msg=k)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
