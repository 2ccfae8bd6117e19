"""Port parity: atom-sharded sampling (``sample/sharded.py``, the targets'
``log_prob_sharded``) and the driver's atom-axis sample mode.

The densities on a (2 x 4) in-process mesh (chains x atoms, 8 virtual
devices) against the JAX package's on its (2 x 4) virtual CPU mesh, fed the
JAX package's own latent draws, and against the port's dense oracle
(``mesh=None``) at the same padded atom count: values 1e-10 relative,
gradients 1e-8 (float64). The driver's atom-axis runs against its dense
runs at an atom count the atom axis divides (1e-8), chunked against
monolithic bit for bit, and JAX's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.flow.integrators import FlowConfig as JFlowConfig
from enflow_tpu.flow.integrators import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.parallel.mesh import get_mesh as j_get_mesh
from enflow_tpu.sample import targets as jtargets
from enflow_tpu.sample.mcmc import batched_value_and_grad as j_vg
from enflow_tpu.sample.sharded import make_sample_fns as j_make_sample_fns

from enflow_tpu_torch.flow.integrators import FlowConfig
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.parallel.mesh import get_mesh
from enflow_tpu_torch.sample import smc, targets
from enflow_tpu_torch.sample.mcmc import batched_value_and_grad
from enflow_tpu_torch.sample.sharded import make_sample_fns
from enflow_tpu_torch.train.driver import Main
from enflow_tpu_torch.utils.jax_params import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

NF, H = 3, 8
N_ATOMS = 6                 # pads to 8 on a 4-shard atom axis
TOL = 1e-10


@pytest.fixture(scope="module")
def meshes():
    return (j_get_mesh(("data", "atom"), shape=(2, 4)),
            get_mesh(("data", "atom"), (2, 4), virtual_devices=8))


def _flow():
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(0), jcfg, jnp.float64)
    return jcfg, jp, FlowConfig(egcl=EGCLConfig(NF, H), **kw), \
        from_jax_params(jp, device="cpu")


def _targets(name):
    args = {"lj_cluster": ((N_ATOMS,), dict(kBT=2.0, softening=0.1,
                                            e_cap=500.0)),
            "lj_cluster_unsoftened": ((N_ATOMS,), dict(kBT=2.0)),
            "lj_fluid": ((N_ATOMS,), dict(box=2.5, kBT=2.0, softening=0.1,
                                          cutoff=1.2, e_cap=500.0)),
            "double_well": ((N_ATOMS,), dict(dim=3)),
            "gaussian": (((N_ATOMS, 3),), dict(std=1.3))}[name]
    fn = "lj_cluster" if name.startswith("lj_cluster") else name
    return (getattr(jtargets, fn)(*args[0], **args[1]),
            getattr(targets, fn)(*args[0], **args[1]))


def _jax_latents(key, n, n_pad):
    """The JAX package's ``propose`` draws, its padded atoms zeroed."""
    ks = jax.random.split(key, 4)
    shapes = {"h": NF, "g": NF, "pos": 3, "vel": 3}
    z = {k: np.asarray(jax.random.normal(ks[i], (n, n_pad, d), jnp.float64))
         for i, (k, d) in enumerate(shapes.items())}
    return {k: torch.from_numpy(v * (np.arange(n_pad) < N_ATOMS)[None, :,
                                                                  None])
            for k, v in z.items()}


@pytest.mark.parametrize("name", ["lj_cluster", "lj_cluster_unsoftened",
                                  "lj_fluid", "double_well", "gaussian"])
def test_sample_fns_match_jax_and_dense(meshes, name):
    jmesh, mesh = meshes
    jcfg, jp, tcfg, tp = _flow()
    jt, tt = _targets(name)
    box = 2.5 if name == "lj_fluid" else 1e3
    r_cut = 1.2 if name == "lj_fluid" else 1e2
    jprop, jq0, jlp, jpad = j_make_sample_fns(
        jp, jcfg, jt, N_ATOMS, NF, jnp.float64, box, r_cut, mesh=jmesh)
    prop, q0, lp, pad = make_sample_fns(tp, tcfg, tt, N_ATOMS, box, r_cut,
                                        mesh=mesh)
    dprop, dq0, dlp, dpad = make_sample_fns(tp, tcfg, tt, N_ATOMS, box, r_cut,
                                            n_pad=pad)
    assert jpad == pad == dpad == 8
    key = jax.random.PRNGKey(42)
    jx = jax.jit(lambda k: jprop(k, 8))(key)
    z = _jax_latents(key, 8, pad)
    x, dx = prop(z), dprop(z)
    for k in jx:
        np.testing.assert_allclose(x[k].numpy(), np.asarray(jx[k]), atol=TOL)
        np.testing.assert_allclose(x[k].numpy(), dx[k].numpy(), atol=TOL)
    for jf, f, df in ((jq0, q0, dq0), (jlp, lp, dlp)):
        jv, jg = jax.jit(j_vg(jf))(jx)
        v, g = batched_value_and_grad(f)(x)
        dv, dg = batched_value_and_grad(df)(x)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL)
        np.testing.assert_allclose(v.numpy(), dv.numpy(), rtol=TOL)
        for k in jg:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                       atol=1e-8)
            np.testing.assert_allclose(g[k].numpy(), dg[k].numpy(),
                                       atol=1e-8)


def test_sharded_smc_matches_dense_oracle(meshes):
    """A whole SMC anneal on the sharded densities equals it on the dense
    oracle at the same padded atom count (same generator seeds)."""
    _, mesh = meshes
    _, _, tcfg, tp = _flow()
    _, tt = _targets("lj_cluster")
    runs = []
    for m in (mesh, None):
        prop, q0, lp, pad = make_sample_fns(tp, tcfg, tt, N_ATOMS, 1e3, 1e2,
                                            mesh=m, n_pad=8)
        z = _jax_latents(jax.random.PRNGKey(3), 16, pad)
        runs.append(smc(torch.Generator().manual_seed(4), prop(z),
                        log_q0=q0, log_p=lp, n_temps=4, mcmc_steps=1,
                        step_size=0.05, n_leapfrog=2))
    s, d = runs
    np.testing.assert_allclose(float(s.log_Z), float(d.log_Z), rtol=1e-8)
    np.testing.assert_allclose(s.log_weights.numpy(), d.log_weights.numpy(),
                               atol=1e-8)
    for k in d.particles:
        np.testing.assert_allclose(s.particles[k].numpy(),
                                   d.particles[k].numpy(), atol=1e-8)


YAML = """\
mode: sample
units: {{time: pico, dist: ang}}
precision: float64
seed: 3
dynamics:
  n_iter: 2
  dt: 0.1
  integrator: LF
  nbr_mode: {nbr_mode}
  network: {{hidden_nf: 8, node_nf: 3}}
sampling:
  algo: {algo}
  n_particles: 8
  n_temps: 3
  n_rounds: 3
  mbar: true
  mbar_pool_rounds: 2
  mbar_iters: 50
  ti_nodes: 3
  n_samples: 3
  n_warmup: 1
  mcmc_steps: 1
  step_size: 0.02
  n_leapfrog: 2
  output: {out}
  target: {target}
"""
CLUSTER = "{type: lj_cluster, n_atoms: %d, kBT: 2.0, softening: 0.1}"
FLUID = ("{type: lj_fluid, n_atoms: %d, box: 2.5, r_cut: 1.2, kBT: 2.0, "
         "softening: 0.1, cutoff: 1.2, e_cap: 500.0}")


def _run(tmp_path, name, virtual, algo="smc", n=8, target=CLUSTER,
         sampling="", nbr_mode="all_pairs"):
    out = tmp_path / f"{name}.npz"
    text = YAML.format(algo=algo, out=out, target=target % n,
                       nbr_mode=nbr_mode).replace(
        "  n_temps: 3\n", "  n_temps: 3\n" + sampling)
    if virtual > 1:
        text += "parallel: {atom_axis: 4}\n"
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(text)
    Main(device="cpu", virtual_devices=virtual)(str(cfg))
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("algo,target", [("smc", CLUSTER), ("remc", CLUSTER),
                                         ("ti", CLUSTER), ("smc", FLUID)])
def test_driver_atom_axis_matches_dense(tmp_path, algo, target):
    """8 atoms over a 4-shard atom axis against one device: the same
    draws, the same outputs to round-off (REMC with MBAR)."""
    s = _run(tmp_path, "s", 4, algo, target=target)
    d = _run(tmp_path, "d", 1, algo, target=target)
    assert set(s) == set(d)
    if algo == "remc":
        assert "mbar_log_Z" in s
    for k, v in d.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(s[k], v, rtol=1e-8, atol=1e-8,
                                       err_msg=k)


def test_driver_atom_axis_padded_chunked_equals_monolithic(tmp_path):
    """6 atoms padded to 8: the chunked SMC equals the monolithic one bit
    for bit, and the npz holds the 6 real atoms."""
    mono = _run(tmp_path, "m", 4, n=N_ATOMS)
    chunked = _run(tmp_path, "c", 4, n=N_ATOMS, sampling="  chunk_temps: 2\n")
    assert mono["pos"].shape == (8, N_ATOMS, 3)
    for k, v in mono.items():
        np.testing.assert_array_equal(chunked[k], v, err_msg=k)


def test_driver_atom_axis_refusals(tmp_path):
    """The JAX driver's refusals: an algorithm the sharded densities do not
    serve, the top-k format, an atom axis that does not divide the device
    count (also with the default single virtual device), a target without
    a sharded density."""
    with pytest.raises(NotImplementedError, match="atom-sharded sampling"):
        _run(tmp_path, "x", 4, algo="hmc")
    with pytest.raises(ValueError, match="atom-sharded flow supports"):
        _run(tmp_path, "x", 4, nbr_mode="topk")
    for virtual in (1, 2, 6):
        cfg = tmp_path / "v.yaml"
        cfg.write_text(YAML.format(algo="smc", out=tmp_path / "v.npz",
                                   target=CLUSTER % 8, nbr_mode="all_pairs")
                       + "parallel: {atom_axis: 4}\n")
        with pytest.raises(ValueError, match="must divide the device count"):
            Main(device="cpu", virtual_devices=virtual)(str(cfg))
    # the committed atom_axis: 4 configs on one device, as the JAX driver
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "example"
    for name in ("train_sharded", "sample_sharded", "sample_fluid"):
        with pytest.raises(ValueError, match=r"device count \(1\)"):
            Main(device="cpu").setup(str(root / f"{name}.yaml"))
    _, _, tcfg, tp = _flow()
    no_ring = targets.Target(log_prob=lambda x: x.sum(dim=(1, 2)),
                             dim=(4, 3), name="ff")
    with pytest.raises(NotImplementedError, match="log_prob_sharded"):
        make_sample_fns(tp, tcfg, no_ring, 4, 1e3, 1e2,
                        mesh=get_mesh(("atom",), (4,), virtual_devices=4))


def test_dryrun_multichip_cpu(capsys):
    """The dry run of every sharded program family, 4 virtual devices."""
    from enflow_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[dryrun]")]
    assert len(lines) == 10 and "TI: 3 nodes OK" in lines[-1]
