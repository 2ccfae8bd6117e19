"""Port parity: the solvated-ligand dataset (``enflow_tpu_torch/data/
lig.py``) against the JAX package's, both driven through the fake
OpenMM/OpenFF stack of ``tests/test_lig.py``, and the error without
OpenMM."""

import sys

import numpy as np
import pytest
import yaml

from test_lig import _no_openmm_import, build_fake_openmm

from enflow_tpu.data.lig import LIGDataset as JLIGDataset

from enflow_tpu_torch.data.lig import LIGDataset
from enflow_tpu_torch.train.driver import Main
from torch_threads import one_torch_thread  # noqa: F401

PARAMS = dict(smiles="CCO", force_field=["amber/tip3p_standard.xml"],
              r_cut=5.0, padding=10.0, temp=300.0, n_iter=6, interval=2,
              discard=4, dt=0.002, friction=1.0, seed=11)


@pytest.fixture
def fake_openmm(monkeypatch):
    calls = []
    for name, mod in build_fake_openmm(calls).items():
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


@pytest.mark.parametrize("over", [{}, {"padding": None,
                                       "box": [30.0, 25.0, 20.0]},
                                  {"discard": -1, "time_unit": "femto"}])
def test_lig_samples_match_jax(fake_openmm, over):
    kw = dict(PARAMS, **over)
    j = JLIGDataset(**kw)
    j_calls = list(fake_openmm)
    fake_openmm.clear()
    t = LIGDataset(**kw, device="cpu")
    assert [c[0] for c in fake_openmm] == [c[0] for c in j_calls]
    assert len(t) == len(j) and t.node_nf == j.node_nf
    for a, b in zip(j.samples, t.samples):
        assert a.z == b.z and a.label == b.label and a.r_cut == b.r_cut
        for f in ("h", "g", "pos", "vel", "box"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=0, atol=1e-12)


def test_lig_errors_match_jax(fake_openmm, monkeypatch):
    kw = dict(PARAMS, padding=None)
    builds = ((JLIGDataset, {}), (LIGDataset, {"device": "cpu"}))
    for cls, dev in builds:
        with pytest.raises(ValueError, match="either `padding` or `box`"):
            cls(**kw, **dev)
    for name in list(sys.modules):
        if name.startswith(("openmm", "openff", "openmmforcefields")):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr("builtins.__import__", _no_openmm_import)
    msgs = []
    for cls, dev in builds:
        with pytest.raises(ImportError, match="data-prep only") as e:
            cls(**PARAMS, **dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_driver_trains_from_lig_cache(fake_openmm, tmp_path):
    """mode dataset writes the port's cache, mode train reads it (type:
    lig) on the CPU."""
    cache = str(tmp_path / "lig.pkl")
    cfg = {
        "mode": "dataset", "units": {"time": "pico", "dist": "ang"},
        "precision": "float64", "seed": 3,
        "dataset": {"type": "lig", "smiles": "CCO",
                    "force_field": ["amber/tip3p_standard.xml"],
                    "padding": 10.0, "r_cut": 5.0, "n_iter": 6,
                    "interval": 2, "discard": 2, "processed_file": cache},
        "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 1,
                     "nbr_mode": "all_pairs",
                     "checkpoint_path": str(tmp_path / "lig.cpt"),
                     "network": {"hidden_nf": 8}},
        "training": {"num_epochs": 2, "batch_size": 2, "lr": 1e-3,
                     "scheduler": False,
                     "loss": {"temp": 300, "softening": 0.5},
                     "log_interval": 1},
    }
    path = tmp_path / "lig.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ds = Main(device="cpu")(str(path))
    assert len(ds) == 3 and (tmp_path / "lig.torch.npz").exists()
    fake_openmm.clear()
    cfg["mode"] = "train"
    path.write_text(yaml.safe_dump(cfg))
    Main(device="cpu")(str(path))
    assert fake_openmm == []          # the cache, not OpenMM
    assert (tmp_path / "lig.cpt").exists()
