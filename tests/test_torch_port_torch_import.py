"""Port parity: reference-checkpoint import and export
(``enflow_tpu_torch/utils/torch_import.py`` and ``torch_export.py``)
against the JAX package's modules.

The reference ``model.cpt`` is built in the process from a numpy-seeded
generator under the reference's state-dict keys (torch Linear ``[out,
in]``), as ``tests/test_torch_import.py`` builds it. Checks: the port's
npz holds the JAX module's keys and bytes; the imported flow computes
JAX's outputs (float64, 1e-10); the export equals JAX's export; import ->
export gives the input back bit for bit; the refusals.
"""

import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import forward_core as j_forward_core
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from enflow_tpu.utils import torch_export as j_export
from enflow_tpu.utils import torch_import as j_import

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, forward_core
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.train.checkpoint import (has_tree, load_checkpoint,
                                               load_hparams, save_checkpoint)
from enflow_tpu_torch.utils import torch_export, torch_import
from torch_threads import one_torch_thread  # noqa: F401

NF, HIDDEN, N_ITER = 4, 8, 3
F64 = torch.float64


def make_state_dict(rng, n_networks=N_ITER, attention=False):
    """Random float64 tensors under the reference's keys and shapes."""
    def lin(out_d, in_d, prefix, bias=True):
        d = {prefix + ".weight": torch.tensor(rng.normal(size=(out_d, in_d)),
                                              dtype=F64)}
        if bias:
            d[prefix + ".bias"] = torch.tensor(rng.normal(size=(out_d,)),
                                               dtype=F64)
        return d

    sd = {}
    for k in range(n_networks):
        p = f"networks.{k}."
        sd.update(lin(HIDDEN, 2 * NF + 1, p + "edge_nn.0"))
        sd.update(lin(HIDDEN, HIDDEN, p + "edge_nn.2"))
        sd.update(lin(HIDDEN, HIDDEN + NF, p + "node_nn.0"))
        sd.update(lin(NF, HIDDEN, p + "node_nn.2"))
        sd.update(lin(HIDDEN, HIDDEN, p + "coord_nn.0"))
        sd.update(lin(1, HIDDEN, p + "coord_nn.2", bias=False))
        sd.update(lin(HIDDEN, NF, p + "vel_scaling_nn.0"))
        sd.update(lin(1, HIDDEN, p + "vel_scaling_nn.2"))
        if attention:
            sd.update(lin(1, HIDDEN, p + "att_nn.0"))
    sd.update(lin(HIDDEN, NF, "dequantize.network.0"))
    sd.update(lin(2 * NF, HIDDEN, "dequantize.network.2"))
    # scaled down: random-normal weights explode through exp(Q) otherwise
    return {k: v * 0.1 for k, v in sd.items()}


def make_ckpt(tmp_path, seed, name="model.cpt", **over):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / name)
    ckpt = {"epoch": 7, "model_state_dict": make_state_dict(rng),
            "optimizer_state_dict": {}, "node_nf": NF, "hidden_nf": HIDDEN,
            "softening": 0.1, "lj_kBT": 0.83, "integrator": "lf",
            "n_iter": N_ITER, "dt": 0.05}
    ckpt.update(over)
    torch.save(ckpt, path)
    return path


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_import_npz_equals_jax_byte_for_byte(tmp_path, dtype):
    cpt = make_ckpt(tmp_path, 0)
    j_npz, t_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_import.import_reference_checkpoint(cpt, j_npz, dtype)
    _, hp = torch_import.import_reference_checkpoint(cpt, t_npz, dtype,
                                                     device="cpu")
    a, b = _members(j_npz), _members(t_npz)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k          # the .npy member, header included
    assert load_hparams(t_npz) == hp and not has_tree(t_npz, "opt_state")
    with np.load(t_npz) as z:
        assert {z[k].dtype for k in z.files if k != "hparams"} == {
            np.dtype(dtype)}


def test_import_cli_writes_the_same_file(tmp_path):
    cpt = make_ckpt(tmp_path, 1)
    out = str(tmp_path / "cli.npz")
    ref = str(tmp_path / "jax.npz")
    j_import.import_reference_checkpoint(cpt, ref, "float32")
    # the CLI runs on the card; without one it refuses (the device rule)
    # and the file comes from the same function on the CPU
    rc = subprocess.run(
        [sys.executable, "-m", "enflow_tpu_torch.utils.torch_import", cpt,
         out, "float32"], capture_output=True, text=True)
    if torch.cuda.is_available():
        assert rc.returncode == 0, rc.stderr
    else:
        assert rc.returncode != 0 and "device='cpu'" in rc.stderr
        torch_import.import_reference_checkpoint(cpt, out, "float32",
                                                 device="cpu")
    a, b = _members(ref), _members(out)
    assert a == b


def _systems(seed, B=2, N=5, box_len=7.0, r_cut=3.0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, NF, size=(B, N))
    arrs = {"h": np.eye(NF)[idx], "g": rng.normal(size=(B, N, NF)) * 0.4,
            "pos": rng.uniform(-box_len / 2, box_len / 2, (B, N, 3)),
            "vel": rng.normal(size=(B, N, 3)) * 0.4}
    mask = np.ones((B, N), bool)
    box = np.full((B, 3), box_len)
    rc = np.full((B,), r_cut)
    jsys = JSystem(mask=jnp.asarray(mask), box=jnp.asarray(box),
                   r_cut=jnp.asarray(rc),
                   **{k: jnp.asarray(v) for k, v in arrs.items()})
    tsys = System(mask=torch.from_numpy(mask), box=torch.from_numpy(box),
                  r_cut=torch.from_numpy(rc),
                  **{k: torch.from_numpy(v.copy()) for k, v in arrs.items()})
    return jsys, tsys


@pytest.mark.parametrize("nbr_mode", ["images", "dense"])
def test_imported_flow_matches_jax(tmp_path, nbr_mode):
    cpt = make_ckpt(tmp_path, 2)
    jp, hp = j_import.load_reference_checkpoint(cpt)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), jp)
    tp, thp = torch_import.import_reference_checkpoint(
        cpt, str(tmp_path / "m.npz"), device="cpu")
    assert thp == hp
    kw = dict(n_iter=N_ITER, dt=hp["dt"], nbr_mode=nbr_mode,
              nbr_capacity=16)
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, HIDDEN), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, HIDDEN), **kw)
    jsys, tsys = _systems(3)
    jout, jldj = j_forward_core(jp, jcfg, jsys)
    tout, tldj = forward_core(tp, tcfg, tsys)
    for f in ("h", "g", "pos", "vel"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10,
                               atol=1e-10)


def test_export_equals_jax_export_and_round_trips(tmp_path):
    cpt = make_ckpt(tmp_path, 4)
    npz = str(tmp_path / "m.npz")
    torch_import.import_reference_checkpoint(cpt, npz, device="cpu")
    j_out, t_out = str(tmp_path / "jax.cpt"), str(tmp_path / "port.cpt")
    j_export.export_reference_checkpoint(npz, j_out, lr=2e-3)
    sd, hp = torch_export.export_reference_checkpoint(npz, t_out, lr=2e-3,
                                                      device="cpu")
    a = torch.load(j_out, weights_only=False)
    b = torch.load(t_out, weights_only=False)
    src = torch.load(cpt, weights_only=False)
    assert list(a["model_state_dict"]) == list(b["model_state_dict"])
    assert set(src["model_state_dict"]) == set(b["model_state_dict"])
    for k, v in b["model_state_dict"].items():
        assert v.dtype == F64 and v.shape == a["model_state_dict"][k].shape
        assert torch.equal(v, a["model_state_dict"][k]), k
        assert torch.equal(v, src["model_state_dict"][k]), k
    assert a["optimizer_state_dict"] == b["optimizer_state_dict"]
    assert b["optimizer_state_dict"]["param_groups"][0]["lr"] == 2e-3
    for k in ("epoch", "node_nf", "hidden_nf", "softening", "lj_kBT",
              "integrator", "n_iter", "dt"):
        assert a[k] == b[k] == src[k], k
    # the exported dict restores into torch Adam and steps
    params = [torch.nn.Parameter(t.clone())
              for t in b["model_state_dict"].values()]
    opt = torch.optim.Adam(params, lr=1e-3)
    opt.load_state_dict(b["optimizer_state_dict"])
    sum((p ** 2).sum() for p in params).backward()
    opt.step()


def test_export_of_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (its own init_flow) exports to
    the same state dict through either package."""
    cfg = JFlowConfig(n_iter=2, dt=0.05, egcl=JEGCLConfig(3, 8))
    params = j_init_flow(jax.random.PRNGKey(5), cfg, jnp.float64)
    npz = str(tmp_path / "j.npz")
    j_save_checkpoint(npz, {"params": params},
                      {"epoch": 1, "node_nf": 3, "hidden_nf": 8,
                       "n_iter": 2, "dt": 0.05, "integrator": "lf"})
    sd_j = j_export.params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params))
    sd_t, _ = torch_export.export_reference_checkpoint(
        npz, str(tmp_path / "x.cpt"), device="cpu")
    assert list(sd_j) == list(sd_t)
    for k in sd_j:
        assert torch.equal(sd_j[k], sd_t[k]), k


def test_attention_networks_import(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "att.cpt")
    torch.save({"epoch": 0, "model_state_dict": make_state_dict(
        rng, attention=True), "node_nf": NF, "hidden_nf": HIDDEN,
        "softening": 0.0, "lj_kBT": 1.0, "integrator": "lf",
        "n_iter": N_ITER, "dt": 0.05}, path)
    jp, _ = j_import.load_reference_checkpoint(path)
    tp, _ = torch_import.load_reference_checkpoint(path)
    jl = jax.tree_util.tree_leaves(jp)
    from enflow_tpu_torch.utils.jax_params import tree_flatten
    tl, _ = tree_flatten(tp)
    assert len(jl) == len(tl) and "att_nn" in tp["networks"]
    for x, y in zip(jl, tl):
        np.testing.assert_array_equal(x, y)
    sd = torch_export.params_to_state_dict(
        torch_import.import_reference_checkpoint(
            path, str(tmp_path / "a.npz"), device="cpu")[0])
    assert "networks.2.att_nn.0.weight" in sd


def test_refusals(tmp_path):
    rng = np.random.default_rng(7)
    # a vv checkpoint must carry n_iter + 1 networks
    vv = make_ckpt(tmp_path, 8, "vv.cpt", integrator="vv")
    for mod in (j_import, torch_import):
        with pytest.raises(ValueError, match="needs 4"):
            mod.load_reference_checkpoint(vv)
    # networks 0 and 2 only
    sd = make_state_dict(rng)
    sd = {k: v for k, v in sd.items() if not k.startswith("networks.1.")}
    gap = str(tmp_path / "gap.cpt")
    torch.save({"epoch": 0, "model_state_dict": sd, "node_nf": NF,
                "hidden_nf": HIDDEN, "softening": 0.1, "lj_kBT": 0.83,
                "integrator": "lf", "n_iter": N_ITER, "dt": 0.05}, gap)
    with pytest.raises(ValueError, match="non-contiguous"):
        torch_import.load_reference_checkpoint(gap)
    # not a flow
    junk = str(tmp_path / "junk.cpt")
    torch.save({"epoch": 0, "model_state_dict": {"foo.weight":
                                                 torch.zeros(2, 2)},
                "node_nf": NF, "hidden_nf": HIDDEN, "softening": 0.1,
                "lj_kBT": 0.83, "integrator": "lf", "n_iter": N_ITER,
                "dt": 0.05}, junk)
    with pytest.raises(ValueError, match="no networks"):
        torch_import.load_reference_checkpoint(junk)
    # the Floor dequantizer has no reference form
    from enflow_tpu_torch.flow import init_flow
    cfg = FlowConfig(n_iter=2, dt=0.05, egcl=EGCLConfig(3, 8),
                     dequantizer="floor")
    floor = str(tmp_path / "floor.npz")
    save_checkpoint(floor, {"params": init_flow(
        torch.Generator().manual_seed(0), cfg, F64, "cpu")},
        {"epoch": 0, "node_nf": 3, "hidden_nf": 8, "dequantizer": "floor",
         "n_iter": 2, "dt": 0.05})
    with pytest.raises(ValueError, match="ArgMax"):
        torch_export.export_reference_checkpoint(
            floor, str(tmp_path / "x.cpt"), device="cpu")
    # nor a coupled flow's drift networks
    cfg = FlowConfig(n_iter=2, dt=0.05, egcl=EGCLConfig(3, 8),
                     position_update="coupled")
    coupled = init_flow(torch.Generator().manual_seed(0), cfg, F64, "cpu")
    as_numpy = jax.tree_util.tree_map(lambda t: t.numpy(), coupled)
    for mod, params in ((torch_export, coupled), (j_export, as_numpy)):
        with pytest.raises(ValueError, match="coupled"):
            mod.params_to_state_dict(params)


def test_driver_trains_from_imported_checkpoint(tmp_path):
    """reference .cpt -> import -> the port's driver resumes from it with
    a fresh optimizer (mode train, CPU) and saves a full checkpoint."""
    import yaml

    from enflow_tpu_torch.train.driver import Main

    cpt = make_ckpt(tmp_path, 9)
    npz = str(tmp_path / "model.npz")
    torch_import.import_reference_checkpoint(cpt, npz, "float32",
                                             device="cpu")
    xyz = tmp_path / "mols.xyz"
    rng = np.random.default_rng(10)
    with open(xyz, "w") as f:
        for _ in range(4):
            f.write("4\n \n")
            for s, p in zip("HCNO", rng.uniform(0, 3, (4, 3))):
                f.write(f"{s} {p[0]} {p[1]} {p[2]}\n")
    config = {
        "mode": "train", "units": {"time": "pico", "dist": "ang"},
        "precision": "float32", "seed": 0,
        "dataset": {"type": "xyz", "raw_file": str(xyz), "r_cut": 5.0,
                    "box": [10.0, 10.0, 10.0],
                    "atom_types": ["H", "C", "N", "O"]},
        "dynamics": {"checkpoint_path": npz, "nbr_mode": "all_pairs"},
        "training": {"num_epochs": 1, "batch_size": 2, "lr": 1e-3,
                     "log_interval": 1},
    }
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(config))
    main = Main(device="cpu")
    main(str(path))
    assert main.start_epoch == 8 and main.node_nf == NF
    assert has_tree(npz, "opt_state")
    tree, hp = load_checkpoint(npz, {"params": main.params})
    assert hp["epoch"] == 8
    assert all(torch.isfinite(t).all() for t in
               torch_import.tree_flatten(tree["params"])[0])
