"""Port parity: the fluid, double-well and Gaussian targets and their
driver wiring.

The same numpy positions go through ``enflow_tpu.sample.targets`` (one
configuration at a time, as the JAX samplers ``vmap`` it) and the port's
batched ``log_prob``; values and position gradients agree at float64 to
rtol 1e-10. ``lj_fluid`` is also held against a brute-force sum over the
27 nearest images (which is the min-image sum when the cutoff is below
half the box).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from enflow_tpu.sample import targets as JT

from enflow_tpu_torch.sample import targets as TT
from enflow_tpu_torch.train.driver import Main, vi_anneal

P, N = 4, 6


def _pos(seed, box=None, spread=1.0, dim=3):
    rng = np.random.default_rng(seed)
    if box is not None:
        return rng.uniform(-box / 2, box / 2, size=(P, N, dim))
    return rng.normal(size=(P, N, dim)) * spread


def _both(jt, tt, x, **over):
    """(JAX values, JAX gradients, port values, port gradients)."""
    f = lambda p: jt.log_prob(p, **over)
    jv = np.stack([float(f(jnp.asarray(p))) for p in x])
    jg = np.stack([np.asarray(jax.grad(f)(jnp.asarray(p))) for p in x])
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = tt.log_prob(tx, **over)
    tg, = torch.autograd.grad(tv.sum(), tx)
    return jv, jg, tv.detach().numpy(), tg.numpy()


def _close(jv, jg, tv, tg):
    np.testing.assert_allclose(tv, jv, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tg, jg, rtol=1e-10,
                               atol=1e-10 * np.abs(jg).max())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cutoff=1.6),
    dict(softening=0.2, e_cap=5.0),
    dict(softening=0.1, cutoff=1.4, e_cap=50.0, kBT=1.7),
], ids=["plain", "cutoff", "soft_cap", "all"])
def test_lj_fluid_matches_jax_f64(kw):
    box = 3.5
    jt = JT.lj_fluid(N, box=box, **kw)
    tt = TT.lj_fluid(N, box=box, **kw)
    _close(*_both(jt, tt, _pos(1, box)))


@pytest.mark.parametrize("over", [dict(softening=0.2, e_cap=10.0),
                                  dict(softening=0.0, e_cap=1e3)])
def test_lj_fluid_overrides_match_jax(over):
    """The VI anneal passes ``softening``/``e_cap`` per epoch."""
    box = 3.5
    jt = JT.lj_fluid(N, box=box, cutoff=1.5, e_cap=500.0)
    tt = TT.lj_fluid(N, box=box, cutoff=1.5, e_cap=500.0)
    _close(*_both(jt, tt, _pos(2, box), **over))


def test_lj_fluid_min_image_is_the_nearest_image_sum():
    box, cut = 4.0, 1.9
    x = _pos(3, box)
    tt = TT.lj_fluid(N, box=box, cutoff=cut)
    got = tt.log_prob(torch.from_numpy(x)).numpy()
    shifts = np.array(list(itertools.product((-1, 0, 1), repeat=3))) * box
    want = np.zeros(P)
    for b in range(P):
        for i, j in itertools.combinations(range(N), 2):
            d2 = (((x[b, i] - x[b, j])[None] + shifts) ** 2).sum(-1)
            for r2 in d2[d2 < cut * cut]:
                want[b] -= 4.0 * (r2 ** -6 - r2 ** -3)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_lj_fluid_half_box_rounds_half_to_even():
    """A displacement of exactly half the box wraps as ``jnp.round``
    (half to even) does."""
    box = 4.0
    x = np.zeros((1, N, 3))
    x[0, :, 0] = np.arange(N) * 2.0 - 5.0         # steps of box / 2
    x[0, :, 1] = np.arange(N) * 0.9
    jt, tt = JT.lj_fluid(N, box=box), TT.lj_fluid(N, box=box)
    _close(*_both(jt, tt, x))


def test_lj_fluid_coincident_pair():
    """Kept (finite) at softening > 0, dropped at 0, as in JAX."""
    box = 3.5
    x = _pos(4, box)
    x[:, 1] = x[:, 0]
    for soft in (0.0, 0.3):
        jt = JT.lj_fluid(N, box=box, softening=soft)
        tt = TT.lj_fluid(N, box=box, softening=soft)
        jv, jg, tv, tg = _both(jt, tt, x)
        assert np.isfinite(tv).all() and np.isfinite(tg).all()
        _close(jv, jg, tv, tg)


@pytest.mark.parametrize("dim,kw", [(3, dict()), (2, dict(kBT=0.7)),
                                    (3, dict(a=0.3, b=-2.0, c=1.1, d0=3.0,
                                             tau=2.0))])
def test_double_well_matches_jax_f64(dim, kw):
    jt = JT.double_well(N, dim=dim, **kw)
    tt = TT.double_well(N, dim=dim, **kw)
    _close(*_both(jt, tt, _pos(5, spread=2.5, dim=dim)))


@pytest.mark.parametrize("std", [1.0, 0.4])
def test_gaussian_matches_jax_f64(std):
    jt, tt = JT.gaussian((N, 3), std=std), TT.gaussian((N, 3), std=std)
    _close(*_both(jt, tt, _pos(6)))


def _vi_yaml(tmp_path, target, **dyn):
    cfg = {"mode": "train", "units": {"time": "pico", "dist": "ang"},
           "precision": "float64", "seed": 0,
           "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 1,
                        "nbr_mode": "all_pairs",
                        "network": {"hidden_nf": 8, "node_nf": 2}, **dyn},
           "training": {"objective": "flow_vi", "num_epochs": 1,
                        "steps_per_epoch": 1, "n_particles": 4, "lr": 1e-3,
                        "scheduler": "No", "log_interval": 1,
                        "target": target}}
    path = tmp_path / "vi.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("target,cls", [
    ({"type": "lj_fluid", "n_atoms": 5, "box": 6.5, "cutoff": 3.0,
      "kBT": 1.0, "e_cap": 500.0}, "ljfluid5"),
    ({"type": "double_well", "n_atoms": 4, "kBT": 1.0}, "dw4"),
    ({"type": "gaussian", "n_atoms": 3, "std": 2.0}, "gaussian"),
], ids=["lj_fluid", "double_well", "gaussian"])
def test_driver_builds_the_targets(tmp_path, target, cls):
    main = Main(device="cpu")
    main.setup(_vi_yaml(tmp_path, target))
    assert main.vi_target.name == cls
    assert main.vi_n_atoms == target["n_atoms"]
    x = _pos(7)[:, :target["n_atoms"]]
    kw = {k: v for k, v in target.items() if k not in ("type", "n_atoms",
                                                       "std")}
    if target["type"] == "lj_fluid":
        jt = JT.lj_fluid(5, **kw)
        assert main.vi_box == 6.5           # the base draws' System box
    elif target["type"] == "double_well":
        jt = JT.double_well(4, dim=3, **kw)
    else:
        jt = JT.gaussian((3, 3), std=2.0)
    want = [float(jt.log_prob(jnp.asarray(p))) for p in x]
    np.testing.assert_allclose(
        main.vi_target.log_prob(torch.from_numpy(x)).numpy(), want,
        rtol=1e-10)


def test_driver_target_refusals(tmp_path):
    with pytest.raises(ValueError, match="lj_fluid.*requires 'box'"):
        Main(device="cpu").setup(_vi_yaml(
            tmp_path, {"type": "lj_fluid", "n_atoms": 5}))
    # the force-field target is ported: its atoms come from its parameters,
    # not the section's n_atoms, and it takes no anneal
    chain = {"atoms": [[1.0, 0.2, 0.0]] * 4,
             "bonds": [[0, 1, 100.0, 1.5], [1, 2, 100.0, 1.5],
                       [2, 3, 100.0, 1.5]]}
    main = Main(device="cpu")
    main.setup(_vi_yaml(tmp_path, {"type": "forcefield", "n_atoms": 5,
                                   "kBT": 0.5, "params": chain}))
    assert main.vi_target.name == "forcefield" and main.vi_n_atoms == 4
    with pytest.raises(ValueError, match="lj_cluster and lj_fluid"):
        Main(device="cpu").setup(_vi_yaml(
            tmp_path, {"type": "forcefield", "params": chain,
                       "anneal": {"epochs": 2}}))
    with pytest.raises(ValueError, match="unknown target"):
        Main(device="cpu").setup(_vi_yaml(
            tmp_path, {"type": "lj_glass", "n_atoms": 5}))


def test_vi_anneal_accepts_lj_fluid():
    sched = vi_anneal({"type": "lj_fluid", "box": 6.5, "softening": 0.0,
                       "e_cap": 500.0, "anneal": {"softening_start": 0.2,
                                                  "epochs": 10}})
    assert sched(0) == pytest.approx((0.2, 500.0, 1.0))
    assert sched(5) == pytest.approx((0.1, 500.0, 1.0))
    assert sched(12) == pytest.approx((0.0, 500.0, 1.0))
    with pytest.raises(ValueError, match="lj_cluster and lj_fluid"):
        vi_anneal({"type": "double_well", "anneal": {"epochs": 2}})
