"""The port's observability (``enflow_tpu_torch/utils/observe.py``) and the
NLL trainer's options that use it, on the CPU:

- ``nan_guard`` raises ``FloatingPointError`` on a NaN from the forward
  (the value handed to its check) and from a custom
  ``autograd.Function``'s backward (anomaly mode with NaN checks, the
  kernels' route), checks nothing when off, and restores the anomaly state
  it found;
- ``assert_all_finite`` against the JAX package's on the same trees;
- ``profile_trace`` writes one Chrome trace file, nothing without a
  directory;
- ``mode: train`` with ``training.profile_dir`` (a trace of the second
  epoch only), ``debug.nan_checks`` (a NaN parameter raises with the guard,
  not without), and a ``compose`` dataset of an ``lj`` part and an ``md``
  part read from a ``.gro`` + ``.trr`` written from the first part's
  frames.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.utils.observe import assert_all_finite as j_assert_all_finite

from enflow_tpu_torch.data import formats
from enflow_tpu_torch.train.driver import Main
from enflow_tpu_torch.utils.constants import sigma
from enflow_tpu_torch.utils.observe import (assert_all_finite, nan_guard,
                                            profile_trace)
from torch_threads import one_torch_thread  # noqa: F401


class NaNBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


@pytest.mark.parametrize("prev", [False, True])
def test_nan_guard_raises_and_restores(prev):
    torch.autograd.set_detect_anomaly(prev, check_nan=True)
    try:
        x = torch.ones(3, requires_grad=True)
        with pytest.raises(FloatingPointError, match="loss"):
            with nan_guard(True) as check:
                check((x * float("nan")).sum(), "loss")
        assert torch.is_anomaly_enabled() == prev
        with pytest.raises(FloatingPointError, match="NaNBackward"):
            with nan_guard(True) as check:
                y = NaNBackward.apply(x).sum()
                check(y, "loss")
                y.backward()
        assert torch.is_anomaly_enabled() == prev
        with pytest.raises(ValueError, match="other"):
            with nan_guard(True):
                raise ValueError("other errors pass through")
        assert torch.is_anomaly_enabled() == prev
        # off: the anomaly state is left as it was found (and with it off,
        # nothing is checked)
        x.grad = None
        with nan_guard(False) as check:
            assert torch.is_anomaly_enabled() == prev
            check(x * float("nan"), "loss")
            if not prev:
                NaNBackward.apply(x).sum().backward()
                assert torch.isnan(x.grad).all()
        assert torch.is_anomaly_enabled() == prev
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_assert_all_finite_matches_jax():
    rng = np.random.default_rng(0)
    good = {"a": rng.normal(size=(3, 2)), "b": [rng.normal(size=4),
                                                np.arange(3)]}
    bad = {"a": good["a"].copy(), "b": [good["b"][0].copy(), np.arange(3)]}
    bad["b"][0][[1, 3]] = [np.nan, np.inf]
    to_t = lambda t: {"a": torch.from_numpy(t["a"]),          # noqa: E731
                      "b": [torch.from_numpy(v) for v in t["b"]]}
    to_j = lambda t: {"a": jnp.asarray(t["a"]),              # noqa: E731
                      "b": [jnp.asarray(v) for v in t["b"]]}
    for tree in (good, to_t(good)):
        assert_all_finite(tree, "params")
    j_assert_all_finite(to_j(good), "params")
    with pytest.raises(FloatingPointError) as je:
        j_assert_all_finite(to_j(bad), "params")
    for tree in (bad, to_t(bad)):
        with pytest.raises(FloatingPointError) as te:
            assert_all_finite(tree, "params")
        assert str(te.value) == str(je.value)


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(None):
        torch.ones(4).sum()
    with profile_trace(""):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    d = tmp_path / "prof"
    with profile_trace(str(d)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((d / files[0]).read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


YAML = """\
mode: train
units: {{time: pico, dist: ang}}
precision: float32
seed: 2
dataset: {dataset}
dynamics:
  integrator: lf
  n_iter: 2
  dt: 1
  checkpoint_path: {ckpt}
  nbr_mode: images
  nbr_capacity: auto
  network: {{hidden_nf: 16}}
training:
  num_epochs: {epochs}
  batch_size: 4
  lr: 1e-3
  scheduler: No
  loss: {{temp: 120, softening: 0.1}}
  log_interval: 1
  {extra}
{debug}
"""

LJ = ("{type: lj, n_atoms: 6, box: [10.0, 10.0, 10.0], temp: 120, "
      "n_iter: 160, interval: 20, discard: 40, dt: 0.004, friction: 1, "
      "softening: 0.1, gap: 2, r_cut: 6.0, minimize_steps: 50, "
      "processed_file: %s}")


def _train(tmp_path, epochs=2, extra="", debug="", dataset=None, name="t"):
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(YAML.format(
        dataset=dataset or LJ % (tmp_path / "lj.pkl"),
        ckpt=tmp_path / f"{name}.cpt", epochs=epochs, extra=extra,
        debug=debug))
    return str(cfg)


def test_driver_profile_dir_traces_the_second_epoch(tmp_path, capsys,
                                                    monkeypatch):
    prof = tmp_path / "prof"
    seen = []
    from enflow_tpu_torch.train import driver
    real = driver.profile_trace

    def spy(log_dir=None):
        seen.append(log_dir)
        return real(log_dir)
    monkeypatch.setattr(driver, "profile_trace", spy)
    Main(device="cpu")(_train(tmp_path, 3, f"profile_dir: {prof}"))
    assert seen == [None, str(prof), None]
    files = os.listdir(prof)
    assert len(files) == 1
    names = {ev.get("name", "") for ev in json.loads(
        (prof / files[0]).read_text())["traceEvents"]}
    assert any("pair" in n or "mm" in n or "linear" in n for n in names)


def test_driver_nan_checks(tmp_path, capsys):
    """The guard is transparent on a finite run (same losses, bit for
    bit), raises FloatingPointError on a NaN parameter, and without it
    the NaN run goes through."""
    losses = {}
    for name, debug in (("off", ""), ("on", "debug: {nan_checks: true}")):
        main = Main(device="cpu")
        main.setup(_train(tmp_path, 1, debug=debug, name=name))
        seen = []
        inner = main.train_step

        def step(batch, gen, inner=inner, seen=seen):
            loss, ovf = inner(batch, gen)
            seen.append(float(loss))
            return loss, ovf
        main.train_step = step
        main.train()
        losses[name] = seen
    assert losses["on"] == losses["off"] and all(
        np.isfinite(losses["on"]))
    assert not torch.is_anomaly_enabled()
    for name, debug, raises in (("nan_off", "", False),
                                ("nan_on", "debug: {nan_checks: true}",
                                 True)):
        main = Main(device="cpu")
        main.setup(_train(tmp_path, 1, debug=debug, name=name))
        with torch.no_grad():
            main.params["networks"]["edge_nn"][0]["w"][0, 0, 0] = \
                float("nan")
        if raises:
            with pytest.raises(FloatingPointError, match="loss"):
                main.train()
        else:
            main.train()
        assert not torch.is_anomaly_enabled()


def _write_md_files(tmp_path, samples):
    """A .gro topology and a .trr trajectory (nm, nm/ps, with box and
    velocities) of reduced-unit samples."""
    from enflow_tpu_torch.utils import conversion as cv
    to_nm = sigma * 1e9
    frames = [{"step": i, "time": 0.0,
               "box": np.diag(s.box * to_nm),
               "pos": s.pos * to_nm,
               "vel": cv.lj_to_vel(s.vel, "nm", "pico")}
              for i, s in enumerate(samples)]
    trr = tmp_path / "lj.trr"
    formats.write_trr(str(trr), frames)
    gro = tmp_path / "lj.gro"
    n = samples[0].num_atoms
    with open(gro, "w") as f:
        f.write(f"lj\n{n:5d}\n")
        for i, p in enumerate(frames[0]["pos"], start=1):
            f.write("%5d%-5s%5s%5d%8.3f%8.3f%8.3f\n" % (1, "LJ", "Ar", i,
                                                         *p))
        f.write("%10.5f%10.5f%10.5f\n" % tuple(np.diag(frames[0]["box"])))
    return str(gro), str(trr)


def test_driver_trains_on_a_compose_of_lj_and_md(tmp_path, capsys):
    main = Main(device="cpu")
    main.setup(_train(tmp_path, 1, name="lj"))
    lj = main.dataset
    gro, trr = _write_md_files(tmp_path, lj.samples)
    md = ("{type: md, top_file: %s, traj_file: %s, r_cut: 6.0, "
          "box: [10.0, 10.0, 10.0], atom_types: [Ar]}" % (gro, trr))
    dataset = ("{type: compose, number: 2}\ndataset1: "
               + LJ % (tmp_path / "lj.pkl") + "\ndataset2: " + md)
    comp = Main(device="cpu")
    comp.setup(_train(tmp_path, 1, dataset=dataset, name="compose"))
    ds = comp.dataset
    assert len(ds) == 2 * len(lj) and ds.node_nf == lj.node_nf == 1
    n = len(lj)
    for a, b in zip(ds.samples[:n], ds.samples[n:]):
        # float32 positions in the trr: within its rounding
        np.testing.assert_allclose(b.pos, a.pos, atol=1e-5)
        np.testing.assert_allclose(b.vel, a.vel, atol=1e-4)
        np.testing.assert_allclose(b.box, a.box, atol=1e-5)
        np.testing.assert_array_equal(b.h, a.h)
    comp.train()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("00000 \t") and np.isfinite(
        float(line.split(" \t    ")[1]))
    assert comp.optimizer.steps_taken == -(-2 * n // 4)
