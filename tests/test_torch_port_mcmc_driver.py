"""The port's driver on ``sampling.algo: hmc | mala | nuts`` on the CPU:
``example/sample_lj13_mcmc.yaml`` (its ``adapt_step``, ``target_accept``,
``thin`` and ``step_size``) at a tiny size and in float64, against the
JAX driver on the same config: the npz keys and shapes, the print line up
to its statistics, and the metrics CSV's columns."""

import pathlib

import numpy as np
import pytest
import yaml

from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.train.driver import Main
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mcmc_yaml(tmp_path, name, algo, **over):
    cfg = yaml.safe_load((ROOT / "example" / "sample_lj13_mcmc.yaml")
                         .read_text())
    cfg["precision"] = "float64"
    cfg["dynamics"] = {"n_iter": 2, "dt": 0.1, "integrator": "LF",
                       "nbr_mode": "all_pairs",
                       "network": {"hidden_nf": 8, "node_nf": 3}}
    cfg["sampling"].update(algo=algo, n_particles=8, n_samples=4,
                           n_warmup=3, thin=2, n_leapfrog=3, max_depth=4,
                           output=str(tmp_path / f"{name}.npz"),
                           metrics_csv=str(tmp_path / f"{name}.csv"),
                           target={"type": "lj_cluster", "n_atoms": 4,
                                   "kBT": 2.0, "c_osc": 0.5}, **over)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("algo", ["hmc", "mala", "nuts"])
def test_driver_mcmc_matches_jax_driver_outputs(tmp_path, capsys, algo):
    """``sample_lj13_mcmc.yaml`` (its adapt_step, target_accept and
    step_size) at a tiny size: the npz keys and shapes, the print line up
    to its statistics and the CSV columns equal the JAX driver's."""
    seen = {}
    for name, make in (("jax", JMain), ("port", lambda: Main(device="cpu"))):
        make()(_mcmc_yaml(tmp_path, name, algo))
        line = capsys.readouterr().out.strip().splitlines()[-1]
        head, stats = line.split(f" -> {tmp_path}/{name}.npz  ")
        with np.load(tmp_path / f"{name}.npz") as z:
            shapes = {k: z[k].shape for k in z.files}
            assert str(z["algo"]) == algo and np.isfinite(z["pos"]).all()
        header = (tmp_path / f"{name}.csv").read_text().splitlines()[0]
        seen[name] = (head, shapes, header,
                      [kv.split("=")[0] for kv in stats.split("  ")])
        for kv in stats.split("  "):
            assert np.isfinite(float(kv.split("=")[1]))
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["pos"] == (4 * 8, 4, 3)
