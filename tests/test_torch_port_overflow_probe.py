"""Port parity: the sampling overflow probe (``Main._overflow_stage_fn``)
and its plumbing through SMC, AIS and REMC.

- The port's probe against the JAX driver's on the same particles with
  the JAX parameters carried across: the truncated-slot counts are equal
  exactly in the top-k (``dense``/``topk``) and ``cell`` formats, also
  beyond the probe's 256-particle window.
- The port's driver on ``tests/test_overflow_counter.py``'s sample config
  (``:161-200``): the warning, one ``nbr_overflow`` integer per stage in
  the metrics CSV, chunked == monolithic (the per-stage column included),
  a killed chunked run resumes from its state file (which carries the
  stage metric) and equals the uninterrupted one.
- REMC: ``round_metric_history`` one entry a round through
  ``remc_segments``, chunked == monolithic, the total on the CSV's last
  row; ``remc``/``smc``/``ais`` with a ``stage_fn`` of the caller's.
"""

import copy
import csv

import numpy as np
import pytest
import torch
import yaml

from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.sample import remc as remc_mod
from enflow_tpu_torch.sample.smc import ais, smc
from enflow_tpu_torch.train.driver import Main
from enflow_tpu_torch.utils.jax_params import from_jax_params

# tests/test_overflow_counter.py's sample config
BASE = {
    "mode": "sample",
    "units": {"time": "pico", "dist": "ang"},
    "precision": "float64",
    "seed": 3,
    "dynamics": {
        "integrator": "lf", "n_iter": 1, "dt": 0.05,
        "nbr_mode": "dense", "nbr_capacity": 1,
        "network": {"hidden_nf": 8, "node_nf": 3},
        "checkpoint_path": "",
    },
    "sampling": {
        "algo": "smc",
        "n_particles": 8, "n_temps": 2, "mcmc_steps": 0,
        "target": {"type": "gaussian", "n_atoms": 4, "std": 0.5,
                   "kBT": 1.0},
    },
}


def _write(tmp_path, cfg, name="s.yaml"):
    cfg = copy.deepcopy(cfg)
    sec = cfg["sampling"]
    sec.setdefault("output", str(tmp_path / (name + ".npz")))
    sec.setdefault("metrics_csv", str(tmp_path / (name + ".csv")))
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path), sec


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("mode,extra", [
    ("dense", {"nbr_capacity": 2}),
    ("topk", {"nbr_capacity": 3}),
    ("cell", {"nbr_capacity": 3, "cells_per_dim": 3, "cell_capacity": 2}),
])
def test_probe_counts_equal_jax(tmp_path, mode, extra):
    cfg = copy.deepcopy(BASE)
    cfg["dynamics"].update(nbr_mode=mode, n_iter=2, **extra)
    cfg["sampling"]["target"].update(n_atoms=7, box=5.0, r_cut=1.6)
    path, sec = _write(tmp_path, cfg)
    jm = JMain()
    jm.setup(path)
    tm = Main(device="cpu")
    tm.setup(path)
    tm.params = from_jax_params(jm.params, device="cpu")
    rng = np.random.default_rng(0)
    P, N = 300, 7
    x = {"h": rng.normal(size=(P, N, 3)), "g": rng.normal(size=(P, N, 3)),
         "pos": rng.uniform(-2.5, 2.5, size=(P, N, 3)),
         "vel": rng.normal(size=(P, N, 3)) * 0.3}
    import jax.numpy as jnp
    j_fn = jm._overflow_stage_fn(sec)
    t_fn = tm._overflow_stage_fn(sec)
    for n in (P, 40):
        want = int(j_fn({k: jnp.asarray(v[:n]) for k, v in x.items()}))
        got = t_fn({k: torch.from_numpy(v[:n]) for k, v in x.items()})
        assert got.dtype in (torch.int32, torch.int64) and got.ndim == 0
        assert int(got) == want and want > 0, (n, int(got), want)
    # the window: particles past the 256th are not probed
    x2 = {k: v.copy() for k, v in x.items()}
    x2["pos"][256:] = 0.0
    got2 = t_fn({k: torch.from_numpy(v) for k, v in x2.items()})
    assert int(got2) == int(t_fn({k: torch.from_numpy(v)
                                  for k, v in x.items()}))


def test_driver_smc_probe_warning_and_column(tmp_path, capsys):
    path, sec = _write(tmp_path, BASE)
    res = Main(device="cpu")(path)
    err = capsys.readouterr().err
    assert "neighbor slots truncated across the anneal stages" in err
    rows = _csv(sec["metrics_csv"])
    ovf = [int(r["nbr_overflow"]) for r in rows]
    assert len(ovf) == 2 and sum(ovf) > 0
    assert ovf == res.stage_metric_history.tolist()
    # AIS probes every stage too; an exact format has no probe
    cfg = copy.deepcopy(BASE)
    cfg["sampling"]["algo"] = "ais"
    path, sec = _write(tmp_path, cfg, "ais.yaml")
    res = Main(device="cpu")(path)
    assert res.stage_metric_history.shape == (2,)
    cfg["dynamics"].update(nbr_mode="all_pairs", nbr_capacity=None)
    path, sec = _write(tmp_path, cfg, "exact.yaml")
    res = Main(device="cpu")(path)
    assert res.stage_metric_history is None
    assert {r["nbr_overflow"] for r in _csv(sec["metrics_csv"])} == {""}


def _run_smc(tmp_path, name, **over):
    cfg = copy.deepcopy(BASE)
    cfg["sampling"].update(n_temps=4, mcmc_steps=1, n_leapfrog=2,
                           step_size=0.05, **over)
    path, sec = _write(tmp_path, cfg, name)
    res = Main(device="cpu")(path)
    with np.load(sec["output"]) as z:
        arrays = {k: z[k] for k in z.files}
    ovf = [r["nbr_overflow"] for r in _csv(sec["metrics_csv"])]
    return res, arrays, ovf


def test_driver_chunked_probe_equals_monolithic(tmp_path, capsys):
    a, za, oa = _run_smc(tmp_path, "mono.yaml")
    b, zb, ob = _run_smc(tmp_path, "chunk.yaml", chunk_temps=3)
    assert oa == ob and len(oa) == 4
    assert torch.equal(a.stage_metric_history, b.stage_metric_history)
    for k in za:
        np.testing.assert_array_equal(za[k], zb[k])


def test_driver_probe_survives_a_resume(tmp_path, capsys, monkeypatch):
    a, za, oa = _run_smc(tmp_path, "mono.yaml")
    state = tmp_path / "killed.state.npz"
    orig = Main._save_sample_state

    def save_then_die(self, path, *args):
        orig(self, path, *args)
        raise RuntimeError("killed after the stage checkpoint")
    monkeypatch.setattr(Main, "_save_sample_state", save_then_die)
    with pytest.raises(RuntimeError, match="killed"):
        _run_smc(tmp_path, "killed.yaml", checkpoint_every=2,
                 state_file=str(state))
    with np.load(state) as z:
        assert z["hist_metric"].shape == (2,) and int(z["stage"]) == 2
    monkeypatch.setattr(Main, "_save_sample_state", orig)
    b, zb, ob = _run_smc(tmp_path, "killed.yaml", checkpoint_every=2,
                         state_file=str(state))
    assert "resuming sampling at stage 2" in capsys.readouterr().err
    assert ob == oa
    for k in za:
        np.testing.assert_array_equal(za[k], zb[k])


def _run_remc(tmp_path, name, chunk):
    cfg = copy.deepcopy(BASE)
    cfg["sampling"].update(algo="remc", n_particles=4, n_temps=3,
                           n_rounds=5, discard_rounds=2, mcmc_steps=1,
                           n_leapfrog=2, step_size=0.05, chunk_rounds=chunk)
    path, sec = _write(tmp_path, cfg, name)
    res = Main(device="cpu")(path)
    rows = _csv(sec["metrics_csv"])
    return res, rows


def test_driver_remc_probe_once_a_round(tmp_path, capsys):
    a, ra = _run_remc(tmp_path, "mono.yaml", 0)
    err = capsys.readouterr().err
    assert "neighbor slots truncated across the REMC rounds" in err
    b, rb = _run_remc(tmp_path, "chunk.yaml", 2)
    h = a.round_metric_history
    assert h.shape == (5,) and h.dtype in (torch.int32, torch.int64)
    assert torch.equal(h, b.round_metric_history)
    assert [r["nbr_overflow"] for r in ra] == ["", "", str(int(h.sum()))]
    assert [r["nbr_overflow"] for r in rb] == [r["nbr_overflow"]
                                               for r in ra]
    for k in a.samples:
        assert torch.equal(a.samples[k], b.samples[k])


def _gauss():
    def log_q0(x):
        return -0.5 * (x["pos"] ** 2).sum(dim=(-1, -2))

    def log_p(x):
        return -2.0 * ((x["pos"] - 0.3) ** 2).sum(dim=(-1, -2))
    return log_q0, log_p


def test_samplers_carry_a_stage_fn():
    log_q0, log_p = _gauss()
    g = torch.Generator().manual_seed(0)
    x0 = {"pos": torch.randn((16, 3, 3), generator=g, dtype=torch.float64)}
    probe = lambda x: (x["pos"] > 1.0).sum()       # noqa: E731
    for fn in (smc, ais):
        kw = dict(log_q0=log_q0, log_p=log_p, n_temps=3, mcmc_steps=1,
                  n_leapfrog=2, step_size=0.1)
        with_fn = fn(torch.Generator().manual_seed(1), x0, stage_fn=probe,
                     **kw)
        without = fn(torch.Generator().manual_seed(1), x0, **kw)
        assert without.stage_metric_history is None
        assert with_fn.stage_metric_history.shape == (3,)
        assert torch.equal(with_fn.particles["pos"], without.particles["pos"])
        assert int(with_fn.stage_metric_history[-1]) == int(
            probe(with_fn.particles))
    K, M = 3, 4
    xr = {"pos": torch.randn((K, M, 3, 3), generator=g, dtype=torch.float64)}
    seen = []

    def flat_probe(x):
        seen.append(tuple(x["pos"].shape))
        return probe(x)
    kw = dict(log_p=log_p, log_q0=log_q0, betas=[0.0, 0.5, 1.0], n_rounds=5,
              mcmc_steps=1, n_leapfrog=2, step_size=0.1)
    mono = remc_mod.remc(torch.Generator().manual_seed(2), xr,
                         stage_fn=flat_probe, **kw)
    seg = remc_mod.remc_segments(torch.Generator().manual_seed(2), xr,
                                 stage_fn=flat_probe, chunk_rounds=2, **kw)
    plain = remc_mod.remc(torch.Generator().manual_seed(2), xr, **kw)
    assert set(seen) == {(K * M, 3, 3)} and len(seen) == 10
    assert mono.round_metric_history.shape == (5,)
    assert torch.equal(mono.round_metric_history, seg.round_metric_history)
    assert plain.round_metric_history is None
    assert torch.equal(mono.x_final["pos"], plain.x_final["pos"])
    assert int(mono.round_metric_history[-1]) == int(probe(mono.x_final))
