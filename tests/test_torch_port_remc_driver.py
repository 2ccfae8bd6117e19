"""The port's driver on ``sampling.algo: remc`` on the CPU:
``example/remc_lj13.yaml`` (its 6-slot ladder and per-slot step list) at
a tiny size and in float64 with ``mbar``, against the JAX driver on the
same config: the npz keys and shapes, the print line up to its numbers
and the metrics CSV's columns; a chunked run equal to the monolithic one
bit for bit."""

import pathlib

import numpy as np
import yaml

from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.train.driver import Main
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _remc_yaml(tmp_path, name, **over):
    cfg = yaml.safe_load((ROOT / "example" / "remc_lj13.yaml").read_text())
    cfg["precision"] = "float64"
    cfg["dynamics"] = {"n_iter": 2, "dt": 0.1, "integrator": "LF",
                       "nbr_mode": "all_pairs",
                       "network": {"hidden_nf": 8, "node_nf": 3}}
    cfg["sampling"].update(n_particles=8, n_rounds=6, discard_rounds=2,
                           n_leapfrog=2, mbar=True, mbar_iters=50,
                           mbar_pool_rounds=2, mbar_blocks=2,
                           output=str(tmp_path / f"{name}.npz"),
                           metrics_csv=str(tmp_path / f"{name}.csv"),
                           target={"type": "lj_cluster", "n_atoms": 4,
                                   "kBT": 2.0, "c_osc": 0.5}, **over)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_driver_remc_matches_jax_driver_outputs(tmp_path, capsys):
    """remc_lj13.yaml's ladder (6 slots, the per-slot step list) at a tiny
    size with MBAR: the same npz keys and shapes, print line up to its
    numbers and CSV columns as the JAX driver; a chunked run equal to the
    monolithic one bit for bit."""
    seen = {}
    for name, make in (("jax", JMain), ("port", lambda: Main(device="cpu")),
                       ("chunk", lambda: Main(device="cpu"))):
        make()(_remc_yaml(tmp_path, name, **({"chunk_rounds": 4}
                                             if name == "chunk" else {})))
        line = capsys.readouterr().out.strip().splitlines()[-1]
        head, tail = line.split(f" -> {tmp_path}/{name}.npz  ")
        assert head == "remc: 6 rounds x 8 chains x 6 temps"
        assert tail.startswith("kept 4 rounds  swap_accept=[")
        assert "mbar_log_Z=" in tail and "+-" in tail
        with np.load(tmp_path / f"{name}.npz") as z:
            seen[name] = {k: z[k] for k in z.files}
        rows = (tmp_path / f"{name}.csv").read_text().splitlines()
        assert len(rows) == 7
        seen[name]["header"] = rows[0]
    want, got = seen["jax"], seen["port"]
    assert {k: np.shape(v) for k, v in got.items()} == \
        {k: np.shape(v) for k, v in want.items()}
    np.testing.assert_allclose(got["betas"], want["betas"], rtol=1e-12)
    assert np.isfinite(got["mbar_log_Z"]) and np.isfinite(got["pos"]).all()
    for k, v in seen["chunk"].items():
        if k not in ("header",):
            np.testing.assert_array_equal(v, got[k])
