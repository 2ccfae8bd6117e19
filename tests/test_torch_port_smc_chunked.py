"""The port's chunked, resumable and logged SMC, and the committed configs
of this slice at tiny cuts on the CPU.

- ``smc_segments`` equals ``smc`` bit for bit, adaptive or not, with its
  hooks (``run_segment``, ``on_segment``) and a resume from the state they
  saw (``tests/test_sample.py:435-510`` on the port).
- The driver (``tests/test_vi_sample_modes.py:589-695``): a chunked run
  equals the monolithic one; a run killed after a stage checkpoint resumes
  from the state file and equals the uninterrupted run; one
  ``UNAVAILABLE`` error is retried and counted, any other error is not;
  ``sampling.metrics_csv`` has one row per stage.
- ``example/sample_lj55.yaml``, ``vi_lj55_coupled.yaml``, ``vi_fluid.yaml``
  and ``vi_dw4.yaml`` cut to N <= 6, H = 16 and two steps run through the
  port's driver with finite results (``test_vi_sample_modes.py:751-790,
  942-981`` on the port).
"""

import copy
import math
import pathlib

import numpy as np
import pytest
import torch
import yaml

from enflow_tpu_torch.sample.smc import smc, smc_segments
from enflow_tpu_torch.train import driver as drv
from enflow_tpu_torch.train.driver import Main
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
P, N = 24, 3


def _densities():
    """A Gaussian proposal and a shifted, narrower Gaussian target over
    particle dicts, with the flow densities' shape."""
    def log_q0(x):
        return -0.5 * (x["pos"] ** 2).sum(dim=(1, 2)) \
            - 0.5 * (x["vel"] ** 2).sum(dim=(1, 2))

    def log_p(x):
        return -2.0 * ((x["pos"] - 0.3) ** 2).sum(dim=(1, 2)) \
            - 0.5 * (x["vel"] ** 2).sum(dim=(1, 2))
    return log_q0, log_p


def _x0(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"pos": torch.randn((P, N, 3), generator=g, dtype=torch.float64),
            "vel": torch.randn((P, N, 3), generator=g, dtype=torch.float64)}


def _knobs(adaptive):
    log_q0, log_p = _densities()
    return dict(log_q0=log_q0, log_p=log_p, n_temps=7, mcmc_steps=2,
                n_leapfrog=3, step_size=0.1, adaptive=adaptive,
                adapt_step=True, precondition=True)


def _equal(a, b):
    for k in a.particles:
        assert torch.equal(a.particles[k], b.particles[k]), k
    for f in ("log_weights", "log_Z", "ess_history", "accept_history",
              "beta_history", "step_history"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("adaptive", [False, True])
def test_smc_segments_matches_monolithic(adaptive):
    ref = smc(torch.Generator().manual_seed(1), _x0(), **_knobs(adaptive))
    for chunk in (1, 3, 7, 0):
        got = smc_segments(torch.Generator().manual_seed(1), _x0(),
                           chunk_temps=chunk, **_knobs(adaptive))
        _equal(got, ref)
    assert float(ref.beta_history[-1]) == pytest.approx(1.0)


def test_smc_segments_resume_and_hooks():
    knobs = _knobs(False)
    ref = smc(torch.Generator().manual_seed(2), _x0(1), **knobs)
    calls, seen = [], {}

    def run(f, *a):
        calls.append(f.__name__)
        return f(*a)

    def on_segment(j, state, hists):
        seen[j] = (copy.deepcopy(state), list(hists))

    got = smc_segments(torch.Generator().manual_seed(2), _x0(1),
                       chunk_temps=3, run_segment=run, on_segment=on_segment,
                       **knobs)
    _equal(got, ref)
    assert calls == ["init_fn", "seg_fn", "seg_fn", "seg_fn"]
    assert sorted(seen) == [3, 6, 7]
    # resume from the state after the first segment; x0 is not needed
    state, hists = seen[3]
    resumed = smc_segments(torch.Generator().manual_seed(2), None,
                           chunk_temps=3, start_stage=3, init_state=state,
                           init_hists=hists, **knobs)
    _equal(resumed, ref)


# --- the driver -----------------------------------------------------------

def _sample_yaml(tmp_path, out_name, **sampling):
    cfg = {"mode": "sample", "units": {"time": "pico", "dist": "ang"},
           "precision": "float64", "seed": 5,
           "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 1,
                        "nbr_mode": "all_pairs",
                        "network": {"hidden_nf": 16, "node_nf": 3}},
           "sampling": {"algo": "smc", "n_particles": 16, "n_temps": 6,
                        "mcmc_steps": 1, "step_size": 0.1, "n_leapfrog": 2,
                        "output": str(tmp_path / out_name),
                        "target": {"type": "lj_cluster", "n_atoms": 5,
                                   "kBT": 2.0, "softening": 0.1},
                        **sampling}}
    path = tmp_path / (out_name + ".yaml")
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(path):
    return Main(device="cpu")(path)


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)


def test_driver_chunked_smc_matches_monolithic(tmp_path, capsys):
    _run(_sample_yaml(tmp_path, "mono.npz"))
    _run(_sample_yaml(tmp_path, "chunk.npz", chunk_temps=2))
    _run(_sample_yaml(tmp_path, "ckpt.npz", checkpoint_every=4))
    capsys.readouterr()
    _npz_equal(tmp_path / "mono.npz", tmp_path / "chunk.npz")
    _npz_equal(tmp_path / "mono.npz", tmp_path / "ckpt.npz")
    assert not (tmp_path / "ckpt.npz.state.npz").exists()


def test_driver_chunked_smc_resumes_from_the_state_file(tmp_path, capsys,
                                                         monkeypatch):
    _run(_sample_yaml(tmp_path, "ref.npz", chunk_temps=2))
    path = _sample_yaml(tmp_path, "resumed.npz", chunk_temps=2,
                        checkpoint_every=2)
    state_file = tmp_path / "resumed.npz.state.npz"
    orig = Main._save_sample_state

    class Killed(RuntimeError):
        pass

    def save_then_die(self, p, stage, state, hists):
        orig(self, p, stage, state, hists)
        raise Killed(f"killed after the checkpoint at stage {stage}")

    monkeypatch.setattr(Main, "_save_sample_state", save_then_die)
    with pytest.raises(Killed, match="stage 2"):
        _run(path)
    monkeypatch.setattr(Main, "_save_sample_state", orig)
    assert state_file.exists()
    with np.load(state_file) as z:
        assert int(z["stage"]) == 2 and z["hist_ess"].shape == (2,)
        assert {"x_pos", "gq_pos", "gp_vel", "log_w", "eps"} <= set(z.files)
    _run(path)
    assert "resuming sampling at stage 2" in capsys.readouterr().err
    assert not state_file.exists()
    _npz_equal(tmp_path / "ref.npz", tmp_path / "resumed.npz")
    # a rerun after completion finds no state file and starts over
    _run(path)
    _npz_equal(tmp_path / "ref.npz", tmp_path / "resumed.npz")


def test_driver_retries_unavailable_once(tmp_path, capsys, monkeypatch):
    _run(_sample_yaml(tmp_path, "ok.npz", chunk_temps=3))
    monkeypatch.setattr(drv.time, "sleep", lambda s: None)
    armed = {"n": 0}
    real = drv.flow_densities

    def flaky_densities(*a, **k):
        propose, log_q0, log_p = real(*a, **k)

        def flaky_log_p(x):
            armed["n"] += 1
            if armed["n"] == 3:        # inside the first segment
                raise RuntimeError("UNAVAILABLE: device error (injected)")
            return log_p(x)
        return propose, log_q0, flaky_log_p

    monkeypatch.setattr(drv, "flow_densities", flaky_densities)
    csv = tmp_path / "retry.csv"
    _run(_sample_yaml(tmp_path, "retried.npz", chunk_temps=3,
                      metrics_csv=str(csv)))
    out = capsys.readouterr()
    assert "retrying in 5 s" in out.err and "retries=1" in out.out
    _npz_equal(tmp_path / "ok.npz", tmp_path / "retried.npz")
    rows = csv.read_text().strip().splitlines()
    head = rows[0].split(",")
    assert head == ["time", "stage", "beta", "ess", "accept", "log_Z",
                    "retries", "nbr_overflow"]
    assert len(rows) == 1 + 6
    last = rows[-1].split(",")
    assert last[head.index("retries")] == "1"
    assert math.isfinite(float(last[head.index("log_Z")]))
    assert all(r.split(",")[head.index("nbr_overflow")] == ""
               for r in rows[1:])


@pytest.mark.parametrize("text,retried", [
    ("UNAVAILABLE: device error (injected)", True),
    ("CUDA error: an illegal memory access was encountered", False)])
def test_retrying_runner_retries_only_unavailable(monkeypatch, text,
                                                  retried):
    monkeypatch.setattr(drv.time, "sleep", lambda s: None)
    run, counter = Main(device="cpu")._retrying_runner()
    calls = {"n": 0}

    def once(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError(text)
        return x + 1

    if retried:
        assert run(once, 1) == 2 and counter["n"] == 1
    else:
        with pytest.raises(RuntimeError, match="illegal"):
            run(once, 1)
        assert counter["n"] == 0 and calls["n"] == 1

    def always(x):
        raise RuntimeError(text)
    with pytest.raises(RuntimeError):
        run(always, 1)


def test_metrics_csv_has_one_row_per_stage(tmp_path, capsys):
    csv = tmp_path / "stages.csv"
    res = _run(_sample_yaml(tmp_path, "s.npz", metrics_csv=str(csv)))
    capsys.readouterr()
    rows = [r.split(",") for r in csv.read_text().strip().splitlines()]
    head = rows[0]
    assert [int(r[head.index("stage")]) for r in rows[1:]] == list(range(6))
    betas = [float(r[head.index("beta")]) for r in rows[1:]]
    np.testing.assert_allclose(betas, res.beta_history.numpy())
    assert rows[-1][head.index("retries")] == "0"
    assert all(r[head.index("log_Z")] == "" for r in rows[1:-1])


def test_chunking_refuses_ais(tmp_path):
    with pytest.raises(NotImplementedError, match="support.*algo: smc"):
        _run(_sample_yaml(tmp_path, "a.npz", algo="ais", chunk_temps=2))


# --- the committed configs, cut to the CPU ---------------------------------

def _cut(name, tmp_path, **over):
    cfg = yaml.safe_load((ROOT / "example" / name).read_text())
    dyn = cfg["dynamics"]
    dyn["network"]["hidden_nf"] = 16
    dyn.pop("compute_dtype", None)
    cfg["precision"] = "float64"
    if "checkpoint_path" in dyn:
        dyn["checkpoint_path"] = str(tmp_path / dyn["checkpoint_path"])
    for sec in ("training", "sampling"):
        if sec in cfg:
            cfg[sec]["target"]["n_atoms"] = min(
                5, cfg[sec]["target"]["n_atoms"])
            for k in ("metrics_csv", "output"):
                if k in cfg[sec]:
                    cfg[sec][k] = str(tmp_path / cfg[sec][k])
    if "training" in cfg:
        cfg["training"].update(num_epochs=1, steps_per_epoch=2,
                               n_particles=8)
    for k, v in over.items():
        sec, key = k.split("__")
        cfg[sec][key] = v
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


@pytest.mark.parametrize("name,update,target", [
    ("vi_dw4.yaml", "shift", "dw4"),
    ("vi_fluid.yaml", "drift", "ljfluid5"),
    ("vi_lj55_coupled.yaml", "coupled", "lj5")])
def test_committed_vi_configs_train_on_the_cpu(tmp_path, capsys, name,
                                               update, target):
    path, cfg = _cut(name, tmp_path)
    main = Main(device="cpu")
    main.setup(path)
    assert main.flow_cfg.position_update == update
    assert main.vi_target.name == target
    if update == "drift":
        assert main.vi_box == 6.5          # the base draws' System box
    losses = []
    inner = main.vi_step

    def step(gen, tgt):
        loss, bad = inner(gen, tgt)
        losses.append(float(loss))
        return loss, bad
    main.vi_step = step
    main.train()
    capsys.readouterr()
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert pathlib.Path(cfg["dynamics"]["checkpoint_path"]).exists()
    if update != "shift":
        assert "pos_networks" in main.params


def test_committed_lj55_pipeline_on_the_cpu(tmp_path, capsys):
    """``vi_lj55_coupled.yaml`` then ``sample_lj55.yaml`` with
    ``position_update: coupled`` from its checkpoint (as the config's
    comment prescribes), chunked as committed, equal to the monolithic
    run."""
    vi_path, vi_cfg = _cut("vi_lj55_coupled.yaml", tmp_path)
    Main(device="cpu")(vi_path)
    runs = {}
    for label, chunk in (("chunked", 8), ("mono", 0)):
        path, cfg = _cut("sample_lj55.yaml", tmp_path,
                         sampling__n_particles=16, sampling__n_temps=4,
                         sampling__chunk_temps=chunk and 2,
                         sampling__checkpoint_every=chunk and 2,
                         sampling__output=str(tmp_path / f"{label}.npz"))
        cfg["dynamics"].update(
            checkpoint_path=vi_cfg["dynamics"]["checkpoint_path"],
            position_update="coupled")
        pathlib.Path(path).write_text(yaml.safe_dump(cfg))
        runs[label] = Main(device="cpu")(path)
    capsys.readouterr()
    _npz_equal(tmp_path / "mono.npz", tmp_path / "chunked.npz")
    res = runs["chunked"]
    assert float(res.beta_history[-1]) == pytest.approx(1.0)
    assert math.isfinite(float(res.log_Z))
    assert res.particles["pos"].shape == (16, 5, 3)
