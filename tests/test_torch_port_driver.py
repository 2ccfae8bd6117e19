"""The port's driver end to end on the CPU, its device rule, and import
hygiene (the port and ``chip_smoke.py`` import neither JAX nor the JAX
package)."""

import pathlib
import re

import numpy as np
import pytest
import torch
import yaml

from enflow_tpu_torch import resolve_device
from enflow_tpu_torch.__main__ import main as cli_main
from enflow_tpu_torch.sample.forcefield import ForceField
from enflow_tpu_torch.train.driver import Main

ROOT = pathlib.Path(__file__).resolve().parent.parent

YAML = """\
mode: sample
units: {{time: pico, dist: ang}}
precision: float32
seed: 3
dynamics:
  n_iter: 2
  dt: 0.1
  integrator: LF
  nbr_mode: all_pairs
  compute_dtype: {cdt}
  network: {{hidden_nf: 8, node_nf: 3, use_pallas: {kernel}}}
sampling:
  algo: {algo}
  n_particles: 32
  n_temps: 3
  mcmc_steps: 1
  step_size: 0.02
  n_leapfrog: 2
  output: {out}
  target: {{type: lj_cluster, n_atoms: 4, kBT: 2.0, c_osc: 0.5}}
"""

# the keys the JAX driver writes for an lj_cluster SMC/AIS run
SMC_KEYS = {"pos", "vel", "h", "g", "log_weights", "log_Z", "ess_history",
            "beta_history"}


@pytest.mark.parametrize("algo,cdt,kernel", [("smc", "null", "v3"),
                                             ("ais", "bfloat16", "false")])
def test_driver_sample_cpu(tmp_path, capsys, algo, cdt, kernel):
    out = tmp_path / "samples.npz"
    cfg = tmp_path / "sample.yaml"
    cfg.write_text(YAML.format(algo=algo, cdt=cdt, kernel=kernel, out=out))
    res = Main(device="cpu")(str(cfg))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"sampled 32 particles -> {out}  log_Z=")
    with np.load(out) as z:
        keys = set(z.files)
        assert keys == (SMC_KEYS if algo == "smc"
                        else SMC_KEYS - {"beta_history"})
        assert z["pos"].shape == (32, 4, 3) and z["h"].shape == (32, 4, 3)
        assert np.isfinite(z["log_Z"]) and np.isfinite(z["pos"]).all()
        if algo == "smc":
            assert z["beta_history"][-1] == pytest.approx(1.0)
    assert res.particles["pos"].device.type == "cpu"


def test_driver_rejects_unported_modes(tmp_path, capsys):
    # sampling with a neighbor capacity runs, its overflow probed per stage
    cfg = tmp_path / "sample_capacity.yaml"
    cfg.write_text(YAML.format(algo="smc", cdt="null", kernel="false",
                               out=tmp_path / "x.npz").replace(
        "  nbr_mode: all_pairs\n", "  nbr_mode: dense\n  nbr_capacity: 2\n"))
    res = Main(device="cpu")(str(cfg))
    assert res.stage_metric_history.shape == (3,)
    assert "neighbor slots truncated" in capsys.readouterr().err
    # atom sharding over more devices than there are is refused, as in the
    # JAX driver
    cfg.write_text(YAML.format(algo="smc", cdt="null", kernel="false",
                               out=tmp_path / "x.npz")
                   + "parallel: {atom_axis: 2}\n")
    with pytest.raises(ValueError, match="must divide the device count"):
        Main(device="cpu")(str(cfg))
    # an unknown algo is the JAX driver's ValueError
    cfg.write_text(YAML.format(algo="gibbs", cdt="null", kernel="false",
                               out=tmp_path / "x.npz"))
    with pytest.raises(ValueError, match="smc | ais | remc"):
        Main(device="cpu")(str(cfg))


def test_driver_ignores_compiler_options(tmp_path, capsys):
    """``dynamics.compiler_options`` (XLA flags for a TPU, as
    ``example/sample_lj55.yaml`` sets them) is accepted and ignored, as the
    JAX driver does off a TPU."""
    out = tmp_path / "samples.npz"
    cfg = tmp_path / "sample.yaml"
    text = YAML.format(algo="smc", cdt="null", kernel="false", out=out)
    cfg.write_text(text.replace(
        "  nbr_mode: all_pairs\n",
        "  nbr_mode: all_pairs\n  compiler_options: "
        "{xla_tpu_scoped_vmem_limit_kib: \"49152\"}\n"))
    assert "compiler_options" in cfg.read_text()
    Main(device="cpu")(str(cfg))
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        f"sampled 32 particles -> {out}")
    # the committed LJ55 config sets up, and its chunked knobs reach the
    # sampler (the run itself is for the card: 1024 particles of LJ55)
    main = Main(device="cpu")
    main.setup(str(ROOT / "example" / "sample_lj55.yaml"))
    seen = {}

    def chunked(sec, gen, propose_z, P, n_atoms, knobs, chunk, ckpt_every):
        seen.update(P=P, n_atoms=n_atoms, chunk=chunk, every=ckpt_every,
                    n_temps=knobs["n_temps"], sweeps=knobs["mcmc_steps"])
        raise StopIteration
    main._run_smc_chunked = chunked
    with pytest.raises(StopIteration):
        main.sample()
    assert seen == dict(P=1024, n_atoms=55, chunk=8, every=8, n_temps=16,
                        sweeps=2)


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Main()
    # every sampling algo and the force-field target's parameters
    for algo in ("smc", "ais", "hmc", "mala", "nuts", "remc", "ti"):
        cfg = tmp_path / f"{algo}.yaml"
        cfg.write_text(YAML.format(algo=algo, cdt="null", kernel="v3",
                                   out=tmp_path / "x.npz"))
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main([str(cfg)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForceField.from_dict({"atoms": [[1.0, 0.1, 0.0]] * 2})
    # sampling with a capacity (the overflow probe), and the import and
    # export of a reference checkpoint
    cfg = tmp_path / "probe.yaml"
    cfg.write_text(YAML.format(algo="remc", cdt="null", kernel="false",
                               out=tmp_path / "x.npz").replace(
        "  nbr_mode: all_pairs\n", "  nbr_mode: topk\n  nbr_capacity: 2\n"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main([str(cfg)])
    # training on a compose dataset with the profiler and the NaN guard
    train = {"mode": "train", "units": {"time": "pico", "dist": "ang"},
             "dataset": {"type": "compose", "number": 1,
                         "dataset1": {"type": "xyz", "raw_file": "x.xyz"}},
             "training": {"profile_dir": str(tmp_path / "prof")},
             "debug": {"nan_checks": True}}
    cfg.write_text(yaml.safe_dump(train))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main([str(cfg)])
    # the atom-sharded configs with virtual devices, and the dry run
    for name in ("train_sharded", "sample_sharded", "sample_fluid"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main([str(ROOT / "example" / f"{name}.yaml"),
                      "--virtual-devices", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Main(virtual_devices=4)
    from enflow_tpu_torch.parallel.dryrun import dryrun_multichip
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(4)
    from enflow_tpu_torch.utils import torch_export, torch_import
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_import.import_reference_checkpoint(
            str(tmp_path / "missing.cpt"), str(tmp_path / "x.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_export.export_reference_checkpoint(
            str(tmp_path / "missing.npz"), str(tmp_path / "x.cpt"))


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+enflow_tpu\.|"
    r"from\s+enflow_tpu\.|from\s+enflow_tpu\s+import|import\s+enflow_tpu\s*$)",
    re.M)


def test_port_imports_no_jax():
    files = sorted((ROOT / "enflow_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_mutants.py"]
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"enflow_tpu_torch/sample/{m}.py" for m in (
        "forcefield", "mcmc", "nuts", "remc", "mbar", "ti")} <= names
    assert {f"enflow_tpu_torch/{m}.py" for m in (
        "data/formats", "data/readers", "data/lig", "utils/observe",
        "utils/torch_import", "utils/torch_export")} <= names
    # multi-device (ROADMAP A7)
    assert {f"enflow_tpu_torch/{m}.py" for m in (
        "parallel/collectives", "parallel/mesh", "parallel/pairwise",
        "parallel/ring", "parallel/dryrun", "flow/sharded",
        "sample/sharded")} <= names
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
