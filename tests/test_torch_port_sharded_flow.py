"""Port parity: the ring EGCL (``parallel/ring.py``) and the atom-sharded
flow and NLL (``flow/sharded.py``).

The same numpy state and parameters go through the JAX package's sharded
functions on 4 of its virtual CPU devices, the port's on K = 4 virtual
devices in one process, and the port's dense flow; the last molecule is
padded where a case says so. The JAX package's sharded forward draws each
shard's dequantizer noise from ``fold_in(key, shard)``: the test replays
those draws and feeds their concatenation to the port, and to the port's
dense forward. Tolerance: float64 round-off, 1e-10 (1e-8 for the round
trips, as the JAX package's own tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import sharded as jsh
from enflow_tpu.flow.integrators import FlowConfig as JFlowConfig
from enflow_tpu.flow.integrators import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.parallel.mesh import get_mesh as j_get_mesh
from enflow_tpu.parallel.ring import ring_egcl as j_ring_egcl

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import sharded as sh
from enflow_tpu_torch.flow.integrators import (FlowConfig, forward,
                                               forward_core)
from enflow_tpu_torch.flow.loss import alchemical_nll
from enflow_tpu_torch.nn.egcl import EGCLConfig, apply_egcl
from enflow_tpu_torch.data.neighbors import neighbors_with_diffs
from enflow_tpu_torch.parallel.mesh import get_mesh
from enflow_tpu_torch.parallel.ring import ring_egcl
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten
from torch_threads import one_torch_thread  # noqa: F401

K = 4
B, N, NF, H = 3, 16, 4, 16
TOL = 1e-10


@pytest.fixture(scope="module")
def meshes():
    return (j_get_mesh(("atom",), devices=jax.devices()[:K]),
            get_mesh(("atom",), (K,), virtual_devices=K))


def _state(seed=0, pad_last=False, box=20.0, onehot=False):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), bool)
    if pad_last:
        mask[-1, N // 2 + 1:] = False       # the last shard all padding
    arrs = {"h": rng.normal(size=(B, N, NF)), "g": rng.normal(size=(B, N, NF)),
            "pos": rng.uniform(-2.0, 2.0, (B, N, 3)),
            "vel": 0.3 * rng.normal(size=(B, N, 3))}
    if onehot:
        arrs["h"] = np.eye(NF)[np.arange(N) % NF][None].repeat(B, 0)
    arrs = {k: v * mask[..., None] for k, v in arrs.items()}
    boxes, r_cut = np.full((B, 3), box), np.full((B,), 3.0)
    jsys = JSystem(mask=jnp.asarray(mask), box=jnp.asarray(boxes),
                   r_cut=jnp.asarray(r_cut),
                   **{k: jnp.asarray(v) for k, v in arrs.items()})
    tsys = System(mask=torch.from_numpy(mask), box=torch.from_numpy(boxes),
                  r_cut=torch.from_numpy(r_cut),
                  **{k: torch.from_numpy(v.copy()) for k, v in arrs.items()})
    return jsys, tsys


def _cfgs(nbr_mode="dense", **kw):
    kw = dict(n_iter=3, dt=0.05, nbr_mode=nbr_mode, **kw)
    return (JFlowConfig(egcl=JEGCLConfig(NF, H), **kw),
            FlowConfig(egcl=EGCLConfig(NF, H), **kw))


def _close(tsys, jsys, tol=TOL, fields=("h", "g", "pos", "vel")):
    for f in fields:
        np.testing.assert_allclose(getattr(tsys, f).detach().numpy(),
                                   np.asarray(getattr(jsys, f)), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("nbr_mode", ["dense", "all_pairs"])
def test_ring_egcl_matches_jax_and_dense(meshes, nbr_mode):
    jmesh, mesh = meshes
    ax = mesh["atom"]
    cfg_j, cfg_t = JEGCLConfig(NF, H), EGCLConfig(NF, H)
    jp = j_init_egcl(jax.random.PRNGKey(1), cfg_j, jnp.float64)
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _state(seed=1, pad_last=True, box=4.5)

    f = jax.shard_map(
        lambda h, p, m, b, r: j_ring_egcl(jp, cfg_j, h, p, m, b, r, "atom",
                                          nbr_mode=nbr_mode),
        mesh=jmesh, in_specs=(P(None, "atom"),) * 3 + (P(), P()),
        out_specs=(P(None, "atom"),) * 3)
    want = jax.jit(f)(jsys.h, jsys.pos, jsys.mask, jsys.box, jsys.r_cut)
    got = ring_egcl(tp, cfg_t, ax.split(tsys.h), ax.split(tsys.pos),
                    ax.split(tsys.mask), ax.broadcast(tsys.box),
                    ax.broadcast(tsys.r_cut), ax, nbr_mode=nbr_mode)
    got = [ax.gather(t) for t in got]
    nbrs, cd = neighbors_with_diffs(tsys.pos, tsys.box, tsys.mask,
                                    tsys.r_cut, None, nbr_mode)
    dense = apply_egcl(tp, cfg_t, tsys.h, cd, nbrs.idx, nbrs.mask, tsys.mask,
                       all_pairs=nbr_mode == "all_pairs")
    for g, w, d in zip(got, want, dense):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("nbr_mode,pad_last,kw", [
    ("dense", False, {}), ("dense", True, {}), ("all_pairs", True, {}),
    ("dense", True, dict(integrator="vv", exact_ldj=True))])
def test_sharded_cores_match_jax_and_dense(meshes, nbr_mode, pad_last, kw):
    """forward_core and reverse_core, LF and VV with the exact ldj, against
    the JAX package's sharded cores and the port's dense ones; the round
    trip gives the input back."""
    jmesh, mesh = meshes
    cfg_j, cfg_t = _cfgs(nbr_mode, **kw)
    jp = j_init_flow(jax.random.PRNGKey(0), cfg_j, jnp.float64)
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _state(pad_last=pad_last)
    jo, jl = jax.jit(lambda p, s: jsh.sharded_forward_core(
        jmesh, p, cfg_j, s))(jp, jsys)
    to, tl = sh.sharded_forward_core(mesh, tp, cfg_t, tsys)
    do, dl = forward_core(tp, cfg_t, tsys)
    _close(to, jo)
    _close(to, do)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), rtol=TOL, atol=TOL)
    jb, jlr = jax.jit(lambda p, s: jsh.sharded_reverse_core(
        jmesh, p, cfg_j, s))(jp, jo)
    tb, tlr = sh.sharded_reverse_core(mesh, tp, cfg_t, to)
    _close(tb, jb)
    np.testing.assert_allclose(tlr.numpy(), np.asarray(jlr), rtol=TOL,
                               atol=TOL)
    _close(tb, jsys, tol=1e-8)
    np.testing.assert_allclose(tlr.numpy(), -tl.numpy(), atol=1e-8)


@pytest.mark.parametrize("pos_update", ["coupled", "drift"])
def test_sharded_learned_position_update(meshes, pos_update):
    """The drift EGCL on velocity geometry through the ring, and (coupled)
    its psummed ``3 sum(S)``, against JAX and the dense port; open
    boundaries, as the coupled update needs."""
    from tests.test_position_coupling import activate
    jmesh, mesh = meshes
    cfg_j, cfg_t = _cfgs("all_pairs", position_update=pos_update,
                         exact_ldj=True)
    jp = activate(j_init_flow(jax.random.PRNGKey(3), cfg_j, jnp.float64),
                  jax.random.PRNGKey(4))
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _state(seed=5, pad_last=True, box=1e6)
    jo, jl = jax.jit(lambda p, s: jsh.sharded_forward_core(
        jmesh, p, cfg_j, s))(jp, jsys)
    to, tl = sh.sharded_forward_core(mesh, tp, cfg_t, tsys)
    do, dl = forward_core(tp, cfg_t, tsys)
    _close(to, jo)
    _close(to, do)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), rtol=TOL, atol=TOL)
    tb, _ = sh.sharded_reverse_core(mesh, tp, cfg_t, to)
    _close(tb, jsys, tol=1e-8)


def _jax_shard_noise(key, n_blk):
    """The JAX package's sharded forward's ArgMax draws: shard i's block
    from ``fold_in(key, i)``, concatenated over the atoms."""
    return np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (B, n_blk, NF), jnp.float64))
        for i in range(K)], axis=1)


@pytest.mark.parametrize("pad_last", [False, True])
def test_sharded_nll_and_gradient(meshes, pad_last):
    """``make_sharded_nll``'s value and parameter gradient against the JAX
    package's (its own per-shard draws, replayed) and against the port's
    dense ``alchemical_nll(forward(...))`` on the same noise; then the
    sharded forward and reverse give the one-hot input back."""
    jmesh, mesh = meshes
    cfg_j, cfg_t = _cfgs("dense")
    jp = j_init_flow(jax.random.PRNGKey(2), cfg_j, jnp.float64)
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _state(seed=3, pad_last=pad_last, onehot=True)
    key = jax.random.PRNGKey(7)
    kBT, soft = 1.2, 0.1
    j_loss = jsh.make_sharded_nll(jmesh, cfg_j, kBT, soft)
    j_val, j_grad = jax.jit(jax.value_and_grad(j_loss))(jp, jsys, key)
    eps = torch.from_numpy(_jax_shard_noise(key, N // K))

    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    t_val = sh.make_sharded_nll(mesh, cfg_t, kBT, soft)(tp, tsys, eps=eps)
    t_grad = torch.autograd.grad(t_val, leaves)
    out, ldj = forward(tp, cfg_t, tsys, eps=eps)
    d_val = alchemical_nll(out, ldj, kBT, soft)
    d_grad = torch.autograd.grad(d_val, leaves)

    assert float(t_val) == pytest.approx(float(j_val), rel=TOL, abs=TOL)
    assert float(t_val) == pytest.approx(float(d_val), rel=TOL, abs=TOL)
    j_leaves = jax.tree_util.tree_leaves(j_grad)
    for tg, jg, dg in zip(t_grad, j_leaves, d_grad):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8,
                                   atol=TOL)
        np.testing.assert_allclose(tg.numpy(), dg.numpy(), rtol=1e-8,
                                   atol=TOL)

    with torch.no_grad():
        fwd, _ = sh.sharded_forward(mesh, tp, cfg_t, tsys, eps=eps)
        back = sh.sharded_reverse(mesh, tp, cfg_t, fwd)
    np.testing.assert_allclose(back.h.numpy(), tsys.h.numpy(), atol=1e-8)
    np.testing.assert_allclose(back.pos.numpy(), tsys.pos.numpy(), atol=1e-8)


def test_sharded_forward_draws_the_dense_noise(meshes):
    """From one generator seed, the sharded forward draws the noise of the
    whole molecules and splits it, so it equals the dense forward."""
    _, mesh = meshes
    _, cfg_t = _cfgs("all_pairs", dequantizer="floor")
    tp = from_jax_params(j_init_flow(jax.random.PRNGKey(5), _cfgs(
        "all_pairs", dequantizer="floor")[0], jnp.float64), device="cpu")
    _, tsys = _state(seed=4, onehot=True)
    so, sl = sh.sharded_forward(mesh, tp, cfg_t, tsys,
                                gen=torch.Generator().manual_seed(9))
    do, dl = forward(tp, cfg_t, tsys, gen=torch.Generator().manual_seed(9))
    _close(so, do)
    np.testing.assert_allclose(sl.numpy(), dl.numpy(), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="noise"):
        forward(tp, dataclasses.replace(cfg_t, axis_name=mesh["atom"]),
                sh.shard_system(tsys, mesh), gen=torch.Generator())


TRAIN = """\
mode: train
units: {{time: pico, dist: ang}}
precision: float64
seed: 2
dataset:
  type: lj
  n_atoms: 8
  box: [24.0, 24.0, 24.0]
  temp: 120
  n_iter: 160
  interval: 20
  discard: 40
  dt: 0.004
  friction: 1
  softening: 0.1
  gap: 2
  r_cut: 3.0
  minimize_steps: 50
  processed_file: {data}/processed.pkl
dynamics:
  integrator: lf
  n_iter: 2
  dt: 1
  checkpoint_path: {ckpt}
  nbr_mode: dense
  network: {{hidden_nf: 16}}
training:
  num_epochs: 2
  batch_size: 4
  lr: 1e-3
  scheduler: No
  loss: {{temp: 120, softening: 0.1}}
  log_interval: 1
"""
GENERATE = """\
mode: generate
units: {{time: pico, dist: ang}}
precision: float64
seed: 2
dataset: {{type: lj, n_atoms: 8, box: [24.0, 24.0, 24.0], discard: -1,
          n_iter: 40, interval: 20, friction: 1, dt: 0.004,
          minimize_steps: 30}}
dynamics: {{checkpoint_path: {ckpt}, nbr_mode: dense}}
"""


def test_driver_atom_axis_train_and_generate_match_dense(tmp_path, capsys):
    """``train_sharded.yaml``'s path at a small size: 8 atoms over a 4-shard
    atom axis train to the dense run's losses and checkpoint (float64,
    1e-10), and ``mode: generate`` through the sharded flow writes the
    dense run's ``h.out`` and ``test_out.xyz`` with both round-trip lines
    True."""
    import os
    from enflow_tpu_torch.train.checkpoint import load_checkpoint
    from enflow_tpu_torch.train.driver import Main

    (tmp_path / "data").mkdir()
    runs = {}
    for virtual in (1, 4):
        d = tmp_path / f"v{virtual}"
        d.mkdir()
        shard = "parallel: {atom_axis: 4}\n" if virtual > 1 else ""
        (d / "t.yaml").write_text(TRAIN.format(data=tmp_path / "data",
                                               ckpt=d / "m.cpt") + shard)
        main = Main(device="cpu", virtual_devices=virtual)
        main(str(d / "t.yaml"))
        assert main.mesh.shape == ({"data": 1, "atom": 4} if virtual > 1
                                   else {"data": 1})
        rows = capsys.readouterr().out.splitlines()[1:]
        losses = [float(r.split()[1]) for r in rows]
        tree, _ = load_checkpoint(str(d / "m.cpt"), {"params": main.params})
        (d / "g.yaml").write_text(GENERATE.format(ckpt=d / "m.cpt") + shard)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            Main(device="cpu", virtual_devices=virtual)(str(d / "g.yaml"))
        finally:
            os.chdir(cwd)
        flags = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln in ("True", "False")]
        assert flags == ["True", "True"]
        runs[virtual] = (losses, tree_flatten(tree["params"])[0],
                         np.loadtxt(d / "h.out"),
                         (d / "test_out.xyz").read_text())
    (l1, p1, h1, x1), (l4, p4, h4, x4) = runs[1], runs[4]
    assert len(l1) == 2 and np.allclose(l4, l1, rtol=TOL, atol=TOL)
    for a, b in zip(p4, p1):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL)
    assert h4.shape == (8,) and np.array_equal(h4, h1)
    xyz = lambda s: np.array([ln.split()[1:] for ln in s.splitlines()[2:]],
                             float)
    np.testing.assert_allclose(xyz(x4), xyz(x1), rtol=1e-8, atol=1e-8)
