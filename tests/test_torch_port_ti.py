"""Port parity: thermodynamic integration (``sample/ti.py``) and the
driver's ``sampling.algo: ti``.

- ``geometric_grid`` and ``_trapezoid_weights`` equal to the JAX
  package's; the grid and step validation raises where the JAX one does.
- TI on a Gaussian bridge with an analytic ``log Z``, within 4 SE plus the
  quadrature estimate; ``chunk_steps`` segments bitwise equal to the
  monolithic node; the ``run_node`` hook sees every dispatch; per-chain
  warmup adaptation and the preconditioned kernel.
- The ``accept[0] < 0.1`` mixing-failure warning raised where the JAX one
  is (a sawtooth flow density that rejects every proposal).
- The driver: ``ti_lj13.yaml``'s schema at a tiny size against the JAX
  driver's npz keys and shapes, print-line prefix and CSV columns.
"""

import math
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from enflow_tpu.sample import ti as jti
from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.sample import ti as tti
from enflow_tpu_torch.train.driver import Main

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOG_2PI = math.log(2.0 * math.pi)
S, MU, D = 1.5, 0.3, 5


def _log_q0(x):
    return -0.5 * sum((v ** 2).sum(-1) for v in x.values()) - 0.5 * D * LOG_2PI


def _log_p(x):
    return -0.5 * sum((((v - MU) / S) ** 2).sum(-1) for v in x.values())


def _x0(C=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((C, 3), generator=gen, dtype=torch.float64),
            "b": torch.randn((C, 2), generator=gen, dtype=torch.float64)}


ANALYTIC = 0.5 * D * math.log(2.0 * math.pi * S * S)


def test_grid_and_weights_match_jax():
    for n, b in ((3, 0.1), (10, 0.02), (25, 0.01)):
        np.testing.assert_array_equal(tti.geometric_grid(n, b),
                                      jti.geometric_grid(n, b))
        g = tti.geometric_grid(n, b)
        np.testing.assert_allclose(
            tti._trapezoid_weights(torch.from_numpy(g)).numpy(),
            np.asarray(jti._trapezoid_weights(jnp.asarray(g))), rtol=1e-15)
    with pytest.raises(ValueError, match="n_nodes"):
        tti.geometric_grid(2)


@pytest.mark.parametrize("bad", [
    dict(betas=[0.0, 0.5, 0.9]), dict(betas=[0.1, 0.5, 1.0]),
    dict(betas=[0.0, 0.6, 0.5, 1.0]), dict(n_steps=10, n_warmup=10)])
def test_ti_validation(bad):
    with pytest.raises(ValueError):
        tti.thermodynamic_integration(torch.Generator(), _x0(4),
                                      log_q0=_log_q0, log_p=_log_p, **bad)


def test_ti_gaussian_analytic_and_hooks():
    calls = []

    def run(f, *a):
        calls.append(f.__name__)
        return f(*a)

    res = tti.thermodynamic_integration(
        torch.Generator().manual_seed(1), _x0(), log_q0=_log_q0,
        log_p=_log_p, n_nodes=10, n_steps=80, n_warmup=30, step_size=0.5,
        step_size_final=0.3, n_leapfrog=4, chunk_steps=40, run_node=run)
    err = abs(float(res.log_Z) - ANALYTIC)
    assert err < 4 * float(res.se) + float(res.quad_err), (
        float(res.log_Z), ANALYTIC, float(res.se), float(res.quad_err))
    acc = res.accept.numpy()
    assert (acc > 0.4).all() and (acc <= 1.0).all()
    # 10 nodes x (cache fill + 2 segments + statistics)
    assert len(calls) == 10 * 4
    assert res.betas.shape == (10,) and res.node_se.shape == (10,)
    np.testing.assert_allclose(res.step_size.numpy()[[0, -1]], [0.5, 0.3],
                               rtol=1e-6)
    flat = torch.cat([v.reshape(-1) for v in res.x.values()])
    assert abs(float(flat.mean()) - MU) < 0.25


def test_ti_chunked_matches_monolithic_with_adaptation():
    kw = dict(n_nodes=5, n_steps=30, n_warmup=10, step_size=0.4,
              n_leapfrog=3, adapt_step=True)
    mono = tti.thermodynamic_integration(
        torch.Generator().manual_seed(6), _x0(16), log_q0=_log_q0,
        log_p=_log_p, **kw)
    chunk = tti.thermodynamic_integration(
        torch.Generator().manual_seed(6), _x0(16), log_q0=_log_q0,
        log_p=_log_p, chunk_steps=7, **kw)
    assert float(mono.log_Z) == float(chunk.log_Z)
    for a, b in ((mono.node_mean, chunk.node_mean),
                 (mono.step_size, chunk.step_size),
                 (mono.x["a"], chunk.x["a"]), (mono.x["b"], chunk.x["b"])):
        assert torch.equal(a, b)
    # the adaptation moved the per-chain steps off the schedule
    assert not np.allclose(mono.step_size.numpy(), [0.4] * 5)


def test_ti_adapt_step_and_precondition():
    """A hopeless initial step (2.5) rescued by the warmup-only per-chain
    adaptation; a 100x anisotropic bridge by the ensemble mass."""
    res = tti.thermodynamic_integration(
        torch.Generator().manual_seed(4), _x0(), log_q0=_log_q0,
        log_p=_log_p, n_nodes=8, n_steps=80, n_warmup=40, step_size=2.5,
        adapt_step=True, target_accept=0.7, n_leapfrog=4)
    acc = res.accept.numpy()
    assert (acc > 0.45).all() and (acc < 0.95).all()
    assert (res.step_size.numpy() < 2.2).all()
    assert abs(float(res.log_Z) - ANALYTIC) < 0.4
    scales = torch.tensor([0.02, 0.02, 1.0, 1.0, 2.0], dtype=torch.float64)

    def lq0(x):
        v = x["a"]
        return (-0.5 * ((v / scales) ** 2).sum(-1) - 0.5 * 5 * LOG_2PI
                - torch.log(scales).sum())

    def lp(x):
        return -0.5 * ((x["a"] / (2.0 * scales)) ** 2).sum(-1)

    gen = torch.Generator().manual_seed(0)
    x0 = {"a": torch.randn((64, 5), generator=gen, dtype=torch.float64)
          * scales}
    analytic = float(sum(0.5 * torch.log(2.0 * math.pi * (2.0 * s) ** 2)
                         for s in scales))
    res = tti.thermodynamic_integration(
        torch.Generator().manual_seed(8), x0, log_q0=lq0, log_p=lp,
        n_nodes=8, n_steps=80, n_warmup=40, step_size=0.5, adapt_step=True,
        precondition=True, n_leapfrog=4)
    assert (res.accept.numpy() > 0.4).all()
    assert abs(float(res.log_Z) - analytic) < 0.4


def test_ti_warns_where_jax_warns():
    """A sawtooth flow density rejects every proposal at beta = 0: both
    packages warn; a smooth one warns in neither."""
    def saw(lib):
        def log_q0(x):
            v = x["a"]
            return (-0.5 * (v ** 2).sum(-1)
                    - 100.0 * lib.cos(300.0 * v).sum(-1))
        return log_q0

    smooth = lambda x: -0.5 * (x["a"] ** 2).sum(-1)
    x0 = np.random.default_rng(0).normal(size=(16, 4))
    kw = dict(n_nodes=3, n_steps=8, n_warmup=2, step_size=0.5, n_leapfrog=2)
    for lq in (saw(jnp), None):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            jti.thermodynamic_integration(
                jax.random.PRNGKey(1), {"a": jnp.asarray(x0)},
                log_q0=smooth if lq is None else lq, log_p=smooth,
                batched=True, **kw)
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            tti.thermodynamic_integration(
                torch.Generator().manual_seed(1),
                {"a": torch.from_numpy(x0)},
                log_q0=smooth if lq is None else saw(torch),
                log_p=smooth, **kw)
        hits = [["TI bridge mixing failure" in str(w.message) for w in ws]
                for ws in (wj, wt)]
        assert any(hits[0]) == any(hits[1]) == (lq is not None)


def _ti_yaml(tmp_path, name):
    cfg = yaml.safe_load((ROOT / "example" / "ti_lj13.yaml").read_text())
    cfg["precision"] = "float64"
    cfg["dynamics"] = {"n_iter": 2, "dt": 0.1, "integrator": "LF",
                       "nbr_mode": "all_pairs",
                       "network": {"hidden_nf": 8, "node_nf": 3}}
    cfg["sampling"].update(n_particles=8, ti_nodes=4, n_samples=4,
                           n_warmup=1, n_leapfrog=2,
                           output=str(tmp_path / f"{name}.npz"),
                           metrics_csv=str(tmp_path / f"{name}.csv"),
                           target={"type": "lj_cluster", "n_atoms": 4,
                                   "kBT": 2.0, "c_osc": 0.5})
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_driver_ti_matches_jax_driver_outputs(tmp_path, capsys):
    seen = {}
    for name, make in (("jax", JMain), ("port", lambda: Main(device="cpu"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            make()(_ti_yaml(tmp_path, name))
        line = capsys.readouterr().out.strip().splitlines()[-1]
        head, tail = line.split(f" -> {tmp_path}/{name}.npz  ")
        assert head == "TI over 4 nodes x 8 chains"
        assert tail.startswith("log_Z=") and "(quad_err " in tail \
            and tail.endswith("retries 0)")
        with np.load(tmp_path / f"{name}.npz") as z:
            seen[name] = {k: z[k].shape for k in z.files}
            assert str(z["algo"]) == "ti"
        rows = (tmp_path / f"{name}.csv").read_text().splitlines()
        assert len(rows) == 5
        seen[name]["header"] = rows[0]
    assert seen["port"] == seen["jax"]
    assert seen["port"]["pos"] == (8, 4, 3)
