"""Port parity: ``mode: generate`` and ``mode: dataset``.

- ``reverse_core``/``forward_core`` in ``dense`` mode with a capacity below
  N (the top-k format, rebuilt every step) and in ``cell`` mode against the
  JAX package at float64, parameters carried across by
  ``from_jax_params``: pos, vel, h, g and ldj within 1e-10, the summed
  overflow exactly; the K = N dense format likewise.
- ``radial_distribution`` against JAX's (1e-12).
- The simulated dataset's ``log`` and ``traj`` files: both packages'
  ``SimulatedDataset.process`` run on the same numpy frames (their MD
  replaced by the same stub) write the same bytes, keep the same frames
  (``discard``) and give the same samples.
- ``nbr_capacity: auto`` and ``_cell_params`` auto against the JAX
  driver's on the same frame; the capacity errors of ``dense`` and
  ``cell`` mode with the JAX driver's text and recommended numbers on
  clustered frames (``tests/test_driver.py:138-170``'s geometry, in
  reduced units), and the ``box < 2 r_cut`` warning.
- The port's driver end to end on the CPU: ``mode: generate`` from a
  checkpoint written by the JAX package's ``save_checkpoint`` (6 atoms,
  float64: ``h.out``, ``test_out.xyz``, the lines ``True``, ``True``),
  with K = N and with a capacity below N (the top-k path), and held
  against the JAX driver's ``generate`` on the same checkpoint and latent
  frame (both MDs stubbed): ``h.out`` byte for byte, ``test_out.xyz``
  within 1e-10 Å; ``mode:
  dataset`` writing its cache, ``log`` and ``traj``, and reading the cache
  back.

Inputs are made with numpy from a seed and fed to both packages.
"""

import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import enflow_tpu.sim as j_sim
from enflow_tpu import native as j_native
from enflow_tpu.data.datasets import Sample as JSample
from enflow_tpu.data.lj import LJDataset as JLJDataset
from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import forward_core as j_forward_core
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.flow import reverse_core as j_reverse_core
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.sim.analysis import radial_distribution as j_rdf
from enflow_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from enflow_tpu.train.driver import Main as JMain
from enflow_tpu.train.driver import _image_edge_max as j_image_edge_max

import enflow_tpu_torch.sim.integrate as t_integrate
from enflow_tpu_torch.data.datasets import Sample
from enflow_tpu_torch.data.lj import LJDataset
from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, forward_core, reverse_core
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import pair_energy
from enflow_tpu_torch.sim import radial_distribution
from enflow_tpu_torch.train.driver import Main
from enflow_tpu_torch.utils.jax_params import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

B, N, NF, H = 2, 24, 2, 16


def _fluid(seed, box_len=6.6, r_cut=2.0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), bool)
    mask[1, -3:] = False
    arrs = {"h": rng.normal(size=(B, N, NF)), "g": rng.normal(size=(B, N, NF)),
            "pos": rng.uniform(-box_len / 2, box_len / 2, (B, N, 3)),
            "vel": rng.normal(size=(B, N, 3))}
    for a in arrs.values():
        a[~mask] = 0.0
    box = np.full((B, 3), box_len)
    rc = np.full((B,), r_cut)
    jsys = JSystem(mask=jnp.asarray(mask), box=jnp.asarray(box),
                   r_cut=jnp.asarray(rc),
                   **{k: jnp.asarray(v) for k, v in arrs.items()})
    tsys = System(mask=torch.from_numpy(mask), box=torch.from_numpy(box),
                  r_cut=torch.from_numpy(rc),
                  **{k: torch.from_numpy(v.copy()) for k, v in arrs.items()})
    return jsys, tsys


@pytest.mark.parametrize("mode,kw", [
    ("dense", dict(nbr_capacity=3)),                      # top-k, K < N
    ("dense", dict()),                                    # K = N
    ("cell", dict(nbr_capacity=10, cells_per_dim=3, cell_capacity=12))])
def test_flow_neighbor_modes_match_jax_f64(mode, kw):
    cfg = dict(n_iter=2, dt=0.1, nbr_mode=mode, track_overflow=True, **kw)
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **cfg)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, H), **cfg)
    jp = j_init_flow(jax.random.PRNGKey(3), jcfg, jnp.float64)
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _fluid(4)
    for j_fn, t_fn in ((j_reverse_core, reverse_core),
                       (j_forward_core, forward_core)):
        jout, jldj, jovf = j_fn(jp, jcfg, jsys)
        with torch.no_grad():
            tout, tldj, tovf = t_fn(tp, tcfg, tsys)
        for f in ("h", "g", "pos", "vel"):
            np.testing.assert_allclose(getattr(tout, f).numpy(),
                                       np.asarray(getattr(jout, f)),
                                       rtol=1e-10, atol=1e-10, err_msg=f)
        np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj),
                                   rtol=1e-10, atol=1e-10)
        assert int(tovf) == int(jovf)
        if kw.get("nbr_capacity") == 3:
            assert int(tovf) > 0            # the top-k truncated slots


def test_radial_distribution_matches_jax():
    rng = np.random.default_rng(8)
    box = np.array([5.0, 6.0, 7.0])
    pos = rng.uniform(-2.5, 2.5, (3, 30, 3))
    mask = np.ones(30, bool)
    mask[-4:] = False
    for m in (None, mask):
        jr, jg = j_rdf(jnp.asarray(pos), jnp.asarray(box), 2.5, 20,
                       None if m is None else jnp.asarray(m))
        tr, tg = radial_distribution(torch.from_numpy(pos),
                                     torch.from_numpy(box), 2.5, 20,
                                     None if m is None
                                     else torch.from_numpy(m))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12)
    # one frame, [N, 3]
    _, jg = j_rdf(jnp.asarray(pos[0]), jnp.asarray(box), 2.5, 20)
    _, tg = radial_distribution(torch.from_numpy(pos[0]),
                                torch.from_numpy(box), 2.5, 20)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12)


def _frames(n_atoms, n_frames, interval, seed=0):
    rng = np.random.default_rng(seed)
    return dict(step=np.arange(1, n_frames + 1) * interval,
                pos=rng.uniform(-2, 2, (n_frames, n_atoms, 3)),
                vel=rng.normal(size=(n_frames, n_atoms, 3)),
                pe=rng.normal(size=n_frames) * 50.0,
                kBT_inst=rng.uniform(0.5, 1.5, n_frames))


@pytest.mark.parametrize("discard", [-1, 40])
def test_dataset_log_and_traj_match_jax(tmp_path, monkeypatch, discard):
    """Both packages' simulated LJ dataset on the same frames: the same
    log and PDB bytes, the same kept frames and samples."""
    fr = _frames(5, 4, 20)
    monkeypatch.setattr(j_sim, "minimize_fire", lambda p, *a, **k: p)
    monkeypatch.setattr(j_sim, "thermalize",
                        lambda *a, **k: jnp.zeros((5, 3)))
    monkeypatch.setattr(j_sim, "simulate", lambda *a, **k: (
        {k2: jnp.asarray(v) for k2, v in fr.items()}, None))
    monkeypatch.setattr(t_integrate, "minimize_fire", lambda p, *a, **k: p)
    monkeypatch.setattr(t_integrate, "thermalize",
                        lambda *a, **k: torch.zeros((5, 3)))
    monkeypatch.setattr(t_integrate, "simulate", lambda *a, **k: {
        k2: torch.from_numpy(v) for k2, v in fr.items()})
    out = {}
    for name, cls, extra in (("jax", JLJDataset, {}),
                             ("port", LJDataset, dict(device="cpu"))):
        d = tmp_path / name
        ds = cls(n_atoms=5, box=[12.0, 12.0, 12.0], temp=120, n_iter=80,
                 interval=20, discard=discard, dt=0.004, node_nf=3,
                 log=str(d / "out" / "log.txt"),
                 traj=str(d / "out" / "traj.pdb"), seed=5, **extra)
        out[name] = (ds, (d / "out" / "log.txt").read_bytes(),
                     (d / "out" / "traj.pdb").read_bytes())
    (jds, jlog, jtraj), (tds, tlog, ttraj) = out["jax"], out["port"]
    assert tlog == jlog and tlog.count(b"\n") == 5
    assert ttraj == jtraj
    assert ttraj.count(b"MODEL ") == len(tds) == len(jds) == (
        4 if discard == -1 else 3)
    for a, b in zip(tds.samples, jds.samples):
        for f in ("h", "g", "pos", "vel", "box"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.label == b.label and a.r_cut == b.r_cut


def _sample(cls, pos, box, r_cut):
    n = pos.shape[0]
    return cls(z=["Ar"] * n, h=np.ones((n, 1)), g=np.zeros((n, 1)), pos=pos,
               vel=np.zeros_like(pos), box=np.asarray(box, np.float64),
               r_cut=float(r_cut))


def test_auto_capacity_and_cells_match_jax():
    """``nbr_capacity: auto`` (the cell-list scan; images mode's slot
    count) and the auto cell parameters on one generate-like frame."""
    rng = np.random.default_rng(9)
    box = np.full(3, 100.0 / 3.4)
    pos = rng.uniform(-0.5, 0.5, (700, 3)) * box
    js, ts = _sample(JSample, pos, box, 3.0), _sample(Sample, pos, box, 3.0)
    fake = lambda s: types.SimpleNamespace(dataset=[s], is_main=True)
    for mode in ("dense", "cell"):
        got = Main._auto_capacity(fake(ts), {"nbr_mode": mode}, "auto")
        assert got == j_native.suggest_capacity(pos, box, 3.0)
    small = pos[:40] / 6.0
    got = Main._auto_capacity(fake(_sample(Sample, small, box / 6.0, 3.0)),
                              {"nbr_mode": "images"}, "auto")
    want = int(np.ceil(j_image_edge_max(small, box / 6.0, 3.0) * 1.25))
    assert got == max(8, ((want + 7) // 8) * 8)
    for dyn in ({"nbr_mode": "cell"},
                {"nbr_mode": "cell", "cells_per_dim": 4},
                {"nbr_mode": "cell", "cell_capacity": 9},
                {"nbr_mode": "dense"}):
        assert Main._cell_params(fake(ts), dyn) == \
            JMain._cell_params(fake(js), dyn)


def _clustered(cls, n_frames=3, n_atoms=8, seed=0):
    """``tests/test_driver.py``'s clustered frames in reduced units: all
    atoms within ~1 A, in a 10 A box with r_cut 9 A."""
    rng = np.random.default_rng(seed)
    return [_sample(cls, rng.uniform(-0.5, 0.5, (n_atoms, 3)) / 3.4,
                    np.full(3, 10.0 / 3.4), 9.0 / 3.4)
            for _ in range(n_frames)]


@pytest.mark.parametrize("dyn", [
    dict(nbr_mode="dense", nbr_capacity=2),
    dict(nbr_mode="cell", nbr_capacity=7, cells_per_dim=1, cell_capacity=2),
    dict(nbr_mode="cell", nbr_capacity=3, cells_per_dim=1, cell_capacity=2),
    dict(nbr_mode="dense", nbr_capacity=7),
    dict(nbr_mode="dense", nbr_capacity=7, capacity_headroom=2.0)])
def test_capacity_errors_match_jax(dyn, capsys):
    """The same error (or pass) and recommended numbers as the JAX
    driver's, and the loud box < 2 r_cut warning of the min-image modes."""
    args = {"dynamics": dict(dyn)}
    flow = dict(n_iter=1, dt=0.1, nbr_mode=dyn["nbr_mode"],
                nbr_capacity=dyn["nbr_capacity"],
                cells_per_dim=dyn.get("cells_per_dim"),
                cell_capacity=dyn.get("cell_capacity"))
    fake = lambda cls, cfg: types.SimpleNamespace(
        flow_cfg=cfg, dataset=_clustered(cls), args=args, is_main=True,
        train_loader=types.SimpleNamespace(n_max=8))
    jf = fake(JSample, JFlowConfig(egcl=JEGCLConfig(1, 8), **flow))
    tf = fake(Sample, FlowConfig(egcl=EGCLConfig(1, 8), **flow))
    errs = []
    for fn, obj in ((JMain._validate_capacities, jf),
                    (Main._validate_capacities, tf)):
        with pytest.warns(UserWarning, match="box < 2\\*r_cut"):
            try:
                fn(obj)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[2] and errs[1] == errs[3]
    if dyn["nbr_capacity"] == 2:
        assert "nbr_capacity=2 is too small" in errs[0]
        assert "Recommended dynamics.nbr_capacity >= 9 (7 observed" in errs[0]
    if dyn.get("cell_capacity") == 2:
        assert "cell_capacity=2 is too small: a cell in this dataset holds " \
            "8 atoms" in errs[0]
        assert "cell_capacity >= 10 (8 observed" in errs[0]
    if dyn["nbr_capacity"] == 3:
        assert "nbr_capacity=3" in errs[0] and "; cell_capacity=2" in errs[0]
    if errs[0] is None:
        assert "within capacity" in errs[1]


GEN = dict(
    mode="generate", units={"time": "pico", "dist": "ang"},
    precision="float64",
    dataset=dict(type="lj", n_atoms=6, box=[14.0, 14.0, 14.0], discard=-1,
                 n_iter=40, interval=20, friction=1, dt=0.004,
                 minimize_steps=30),
    dynamics={})


def _jax_checkpoint(path, node_nf=5, hidden_nf=16, n_iter=2):
    """A checkpoint of the JAX package's driver layout: its flow's params
    and the hparams ``Main._save`` writes."""
    cfg = JFlowConfig(n_iter=n_iter, dt=0.2,
                      egcl=JEGCLConfig(node_nf, hidden_nf))
    params = j_init_flow(jax.random.PRNGKey(11), cfg, jnp.float64)
    j_save_checkpoint(str(path), {"params": params}, dict(
        epoch=2, node_nf=node_nf, hidden_nf=hidden_nf, softening=0.5,
        lj_kBT=1.2, integrator="lf", dequantizer="argmax",
        dequant_scale=1.0, n_iter=n_iter, dt=0.2))


@pytest.mark.parametrize("capacity", [None, 5])
def test_driver_generate_from_jax_checkpoint(tmp_path, capsys, capacity):
    """6 atoms at float64 from the JAX package's checkpoint: with K = N and
    with K = 5 < N (the top-k build in every flow step)."""
    _jax_checkpoint(tmp_path / "model.cpt")
    cfg = yaml.safe_load(yaml.safe_dump(GEN))
    cfg["dynamics"]["checkpoint_path"] = str(tmp_path / "model.cpt")
    if capacity:
        cfg["dynamics"]["nbr_capacity"] = capacity
    path = tmp_path / "gen.yaml"
    path.write_text(yaml.safe_dump(cfg))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        main = Main(device="cpu")
        main(str(path))
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    flags = [ln for ln in out.split("\n") if ln.strip() in ("True", "False")]
    assert flags == ["True", "True"]
    assert main.flow_cfg.nbr_capacity == capacity
    assert main.node_nf == 5 and main.flow_cfg.n_iter == 2
    # the checkpoint's temperature and softening reach the latent sampler
    assert main.args["dataset"]["temp"] == pytest.approx(
        1.2 * 238.0 / 8.3144621)
    h = np.loadtxt(tmp_path / "h.out")
    assert h.shape == (6, 5)
    assert set(np.unique(h)) <= {0.0, 1.0} and (h.sum(1) == 1).all()
    lines = (tmp_path / "test_out.xyz").read_text().splitlines()
    assert lines[0] == "6" and len(lines) == 8
    assert all(ln.startswith("Ar ") and len(ln.split()) == 4
               for ln in lines[2:])


@pytest.mark.parametrize("capacity", [None, 5])
def test_driver_generate_matches_jax(tmp_path, monkeypatch, capsys,
                                     capacity):
    """Both drivers' ``mode: generate`` on the JAX package's checkpoint and
    the same latent frame (both MDs replaced by the same stub): the same
    ``h.out`` bytes and ``test_out.xyz`` atoms, positions within 1e-10 Å,
    and the lines ``True``, ``True`` from each."""
    fr = _frames(6, 2, 20, seed=3)
    monkeypatch.setattr(j_sim, "minimize_fire", lambda p, *a, **k: p)
    monkeypatch.setattr(j_sim, "thermalize",
                        lambda *a, **k: jnp.zeros((6, 3)))
    monkeypatch.setattr(j_sim, "simulate", lambda *a, **k: (
        {k2: jnp.asarray(v) for k2, v in fr.items()}, None))
    monkeypatch.setattr(t_integrate, "minimize_fire", lambda p, *a, **k: p)
    monkeypatch.setattr(t_integrate, "thermalize",
                        lambda *a, **k: torch.zeros((6, 3)))
    monkeypatch.setattr(t_integrate, "simulate", lambda *a, **k: {
        k2: torch.from_numpy(v) for k2, v in fr.items()})
    _jax_checkpoint(tmp_path / "model.cpt")
    cfg = yaml.safe_load(yaml.safe_dump(GEN))
    cfg["dynamics"]["checkpoint_path"] = str(tmp_path / "model.cpt")
    if capacity:
        cfg["dynamics"]["nbr_capacity"] = capacity
    out = {}
    cwd = os.getcwd()
    for name, make in (("jax", JMain), ("port", lambda: Main(device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        (d / "gen.yaml").write_text(yaml.safe_dump(cfg))
        os.chdir(d)
        try:
            make()("gen.yaml")
        finally:
            os.chdir(cwd)
        flags = [ln for ln in capsys.readouterr().out.split("\n")
                 if ln.strip() in ("True", "False")]
        xyz = (d / "test_out.xyz").read_text().splitlines()
        out[name] = (flags, (d / "h.out").read_bytes(), xyz)
    (jflags, jh, jxyz), (tflags, th, txyz) = out["jax"], out["port"]
    assert jflags == tflags == ["True", "True"]
    assert th == jh and th.count(b"\n") == 6
    assert txyz[:2] == jxyz[:2] == ["6", " "]
    rows = lambda xyz: [ln.split() for ln in xyz[2:]]
    assert [r[0] for r in rows(txyz)] == [r[0] for r in rows(jxyz)]
    np.testing.assert_allclose(
        np.array([r[1:] for r in rows(txyz)], float),
        np.array([r[1:] for r in rows(jxyz)], float), rtol=0, atol=1e-10)


def test_driver_generate_needs_a_checkpoint(tmp_path):
    cfg = yaml.safe_load(yaml.safe_dump(GEN))
    cfg["dynamics"]["checkpoint_path"] = str(tmp_path / "missing.cpt")
    path = tmp_path / "gen.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="requires an existing checkpoint"):
        Main(device="cpu")(str(path))


def test_driver_dataset_mode(tmp_path, capsys):
    """``mode: dataset`` writes the processed cache, the log and the
    trajectory; a second run reads the cache and simulates nothing."""
    cfg = yaml.safe_load(yaml.safe_dump(GEN))
    cfg["mode"] = "dataset"
    cfg["dataset"].update(
        temp=120, node_nf=3, processed_file=str(tmp_path / "d" / "p.pkl"),
        log=str(tmp_path / "d" / "log.txt"),
        traj=str(tmp_path / "d" / "traj.pdb"))
    del cfg["dynamics"]
    path = tmp_path / "data.yaml"
    path.write_text(yaml.safe_dump(cfg))
    pair_energy.counts.reset()
    ds = Main(device="cpu")(str(path))
    assert pair_energy.counts.plain_calls == 30 + 40 + 2   # FIRE, MD, frames
    assert len(ds) == 2 and ds[0].h.shape == (6, 3)
    log = (tmp_path / "d" / "log.txt").read_text().splitlines()
    assert log[0] == '#"Step","Potential Energy (kJ/mole)","Temperature (K)"'
    assert [ln.split(",")[0] for ln in log[1:]] == ["20", "40"]
    traj = (tmp_path / "d" / "traj.pdb").read_text()
    assert traj.startswith("CRYST1   14.000   14.000   14.000")
    assert traj.count("MODEL ") == 2 and traj.count("\nATOM  ") == 12
    assert (tmp_path / "d" / "p.torch.npz").exists()
    assert capsys.readouterr().out.count("Potential Energy") == 1
    pair_energy.counts.reset()
    again = Main(device="cpu")(str(path))
    assert pair_energy.counts.plain_calls == 0
    for a, b in zip(again.samples, ds.samples):
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.h, b.h)


TRAIN = """\
mode: train
units: {{time: pico, dist: ang}}
precision: float64
seed: 2
dataset:
  type: lj
  n_atoms: 6
  box: [10.0, 10.0, 10.0]
  temp: 120
  n_iter: 100
  interval: 20
  discard: 20
  dt: 0.004
  softening: 0.1
  r_cut: 6.0
  minimize_steps: 20
dynamics:
  integrator: lf
  n_iter: 2
  dt: 1
  nbr_mode: {mode}
{extra}  network: {{hidden_nf: 8}}
training:
  num_epochs: 1
  batch_size: 2
  lr: 1e-3
  scheduler: No
  loss: {{temp: 120, softening: 0.1}}
  log_interval: 1
  metrics_csv: {csv}
"""


@pytest.mark.parametrize("mode,extra,truncates", [
    ("dense", "  nbr_capacity: auto\n", False),          # auto >= N: K = N
    ("dense", "  nbr_capacity: 2\n  validate_capacity: false\n", True),
    ("cell", "  nbr_capacity: 5\n", False)])
def test_driver_trains_in_dense_and_cell_modes(tmp_path, mode, extra,
                                               truncates):
    """``mode: train`` in the min-image formats on the CPU: an epoch's
    metrics row counts the slots a truncating top-K dropped mid-flow."""
    cfg = tmp_path / "t.yaml"
    csv = tmp_path / "m.csv"
    cfg.write_text(TRAIN.format(mode=mode, extra=extra, csv=csv))
    # the capacity check warns of box < 2 r_cut when it runs
    check = "validate_capacity" not in extra
    with (pytest.warns(UserWarning, match="box < 2\\*r_cut") if check
          else contextlib.nullcontext()):
        main = Main(device="cpu")
        main(str(cfg))
    if mode == "cell":
        assert main.flow_cfg.cells_per_dim == 1
        assert main.flow_cfg.cell_capacity >= 6
    assert main._capacity_can_truncate() == (truncates or mode == "cell")
    rows = csv.read_text().strip().splitlines()
    assert rows[0].endswith(",nbr_overflow") and len(rows) == 2
    loss, ovf = rows[1].split(",")[2], int(rows[1].split(",")[-1])
    assert np.isfinite(float(loss))
    assert (ovf > 0) == truncates
