"""The port's driver on the force-field configs, on the CPU:
``example/vi_ala2.yaml`` cut to a narrow width and a few particles and
steps in float64 (epoch line, metrics CSV, checkpoint, the parameters in
the run's dtype), ``example/sample_ala2.yaml`` from its checkpoint with
the JAX driver's npz keys and shapes and print-line prefix (the JAX driver
runs the same config from the same checkpoint), and the refusal of an
anneal on a force-field target."""

import pathlib

import numpy as np
import pytest
import torch
import yaml

from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.train.driver import Main

ROOT = pathlib.Path(__file__).resolve().parent.parent
ALA2 = yaml.safe_load((ROOT / "example" / "ala2_ff.yaml").read_text())


def _configs(tmp_path):
    """vi_ala2.yaml and sample_ala2.yaml cut to a narrow width and a few
    particles and steps, in float64, in ``tmp_path``."""
    vi = yaml.safe_load((ROOT / "example" / "vi_ala2.yaml").read_text())
    vi["precision"] = "float64"
    vi["dynamics"].update(n_iter=2, checkpoint_path=str(tmp_path / "a.cpt"),
                          network={"hidden_nf": 8, "node_nf": 3})
    vi["training"].update(num_epochs=1, steps_per_epoch=2, n_particles=4,
                          metrics_csv=str(tmp_path / "vi.csv"))
    vi["training"]["target"]["params_file"] = str(ROOT / "example"
                                                  / "ala2_ff.yaml")
    sample = yaml.safe_load((ROOT / "example" / "sample_ala2.yaml")
                            .read_text())
    sample["precision"] = "float64"
    sample["dynamics"]["checkpoint_path"] = str(tmp_path / "a.cpt")
    sample["sampling"].update(n_particles=16, n_temps=2, fe_bins=12)
    sample["sampling"]["target"]["params_file"] = str(
        ROOT / "example" / "ala2_ff.yaml")
    paths = []
    for name, cfg in (("vi", vi), ("sample", sample)):
        p = tmp_path / f"{name}.yaml"
        p.write_text(yaml.safe_dump(cfg))
        paths.append(str(p))
    return paths


def test_driver_vi_ala2_then_sample_ala2(tmp_path, capsys):
    vi_cfg, sample_cfg = _configs(tmp_path)
    main = Main(device="cpu")
    main(vi_cfg)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Epoch \tVI Loss \t   Time (s)"
    assert out[1].startswith("00000 \t") and np.isfinite(
        float(out[1].split(" \t    ")[1]))
    assert main.vi_n_atoms == 22 and main._ff.ke == ALA2["coulomb_const"]
    assert main._ff.sigma.dtype == torch.float64
    assert (tmp_path / "a.cpt").exists()
    header = (tmp_path / "vi.csv").read_text().splitlines()[0]
    assert header == "time,epoch,loss,epoch_seconds,lr,batches"

    got, want = {}, {}
    for name, make, store in (("port", lambda: Main(device="cpu"), got),
                              ("jax", JMain, want)):
        cfg = yaml.safe_load(pathlib.Path(sample_cfg).read_text())
        cfg["sampling"]["output"] = str(tmp_path / f"{name}.npz")
        pathlib.Path(sample_cfg).write_text(yaml.safe_dump(cfg))
        make()(sample_cfg)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.startswith(f"sampled 16 particles -> {tmp_path}/"
                               f"{name}.npz  log_Z=")
        with np.load(tmp_path / f"{name}.npz") as z:
            store.update({k: z[k].shape for k in z.files})
            if name == "port":
                assert np.isfinite(z["log_Z"])
                assert z["beta_history"][-1] == pytest.approx(1.0)
                for k in ("phi_free_energy", "psi_free_energy"):
                    assert np.nanmin(z[k]) == 0.0
    assert got == want
    assert got["dihedrals"] == (16, 23) and got["phi_free_energy"] == (12,)


def test_forcefield_target_refuses_an_anneal(tmp_path):
    vi_cfg, _ = _configs(tmp_path)
    cfg = yaml.safe_load(pathlib.Path(vi_cfg).read_text())
    cfg["training"]["target"]["anneal"] = {"e_cap_start": 100.0, "epochs": 2}
    pathlib.Path(vi_cfg).write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="lj_cluster and lj_fluid"):
        Main(device="cpu").setup(vi_cfg)
