"""Port parity: the force-field target (``sample/forcefield.py``) and the
driver's force-field branch.

Deterministic, float64 against the JAX package on inputs made with numpy:

- ``ff_energy`` and its position gradient, batched in the port and vmapped
  in the JAX package, at 1e-10 relative: ``example/ala2_ff.yaml``'s 22
  atoms at its z-matrix geometry plus Gaussian jitter, and
  ``example/vi_molecule_ff.yaml``'s inline 4-atom chain;
  ``forcefield_target`` with its ``e_cap`` against the JAX
  ``regularize_energy`` path at 1e-10.
- ``dihedral_angles`` at 1e-12; the pair-scale matrices, the z-matrix
  conversion and ``free_energy_profile`` (with and without weights) equal.
- The flow-VI loss and every parameter gradient on the ala2 target at a
  narrow width, 1e-10 (of each array's max for the gradients).
- The driver's ``_ff_extras`` against the JAX driver's on the same
  positions and weights (the configs end to end:
  ``test_torch_port_forcefield_driver.py``).
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.sample import forcefield as jff
from enflow_tpu.sample.vi import flow_vi_loss as j_flow_vi_loss
from enflow_tpu.sample.vi import make_system_target as j_system_target
from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.sample import forcefield as tff
from enflow_tpu_torch.sample.vi import flow_vi_loss, make_system_target
from enflow_tpu_torch.train.driver import Main
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten

ROOT = pathlib.Path(__file__).resolve().parent.parent
ALA2 = yaml.safe_load((ROOT / "example" / "ala2_ff.yaml").read_text())
CHAIN = yaml.safe_load((ROOT / "example" / "vi_molecule_ff.yaml").read_text())[
    "training"]["target"]["params"]


def _both(pd, ke=1.0):
    return (jff.ForceField.from_dict(pd, ke=ke),
            tff.ForceField.from_dict(pd, ke=ke, device="cpu"))


def _ala2_positions(P=6, seed=0, jitter=0.05):
    x0 = jff.zmatrix_to_cartesian(ALA2["zmatrix"])
    rng = np.random.default_rng(seed)
    return x0[None] + jitter * rng.normal(size=(P,) + x0.shape)


def _chain_positions(P=6, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((P, 4, 3))
    x[:, :, 0] = 1.5 * np.arange(4)
    return x + 0.3 * rng.normal(size=x.shape)


def _energy_and_grad(jf, tf, x):
    je, jg = jax.jit(jax.vmap(jax.value_and_grad(jf)))(jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    te = tf(tx)
    (tg,) = torch.autograd.grad(te.sum(), tx)
    return np.asarray(je), np.asarray(jg), te.detach().numpy(), tg.numpy()


@pytest.mark.parametrize("case", ["ala2", "chain"])
def test_ff_energy_and_gradient_match_jax_f64(case):
    if case == "ala2":
        (jf, tf), x = _both(ALA2, ALA2["coulomb_const"]), _ala2_positions()
    else:
        (jf, tf), x = _both(CHAIN), _chain_positions()
    je, jg, te, tg = _energy_and_grad(lambda p: jff.ff_energy(jf, p),
                                      lambda p: tff.ff_energy(tf, p), x)
    assert np.isfinite(je).all() and np.isfinite(jg).all()
    np.testing.assert_allclose(te, je, rtol=1e-10, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=1e-10,
                               atol=1e-10 * np.abs(jg).max())
    np.testing.assert_array_equal(tf.lj_scale.numpy(), np.asarray(jf.lj_scale))
    np.testing.assert_array_equal(tf.q_scale.numpy(), np.asarray(jf.q_scale))
    assert tf.n_atoms == jf.n_atoms and tf.ke == jf.ke


@pytest.mark.parametrize("capped", [False, True])
def test_forcefield_target_matches_jax_f64(capped):
    """ala2 at a large jitter; the cap at the energies' median, so that
    capped and uncapped configurations both occur, through the cap's log
    branch and its gradient."""
    jf, tf = _both(ALA2, ALA2["coulomb_const"])
    x = _ala2_positions(P=8, seed=2, jitter=0.12)
    u = tff.ff_energy(tf, torch.from_numpy(x)).numpy()
    e_cap = float(np.median(u)) if capped else None
    jt = jff.forcefield_target(jf, kBT=0.59616, e_cap=e_cap)
    tt = tff.forcefield_target(tf, kBT=0.59616, e_cap=e_cap)
    je, jg, te, tg = _energy_and_grad(jt.log_prob, tt.log_prob, x)
    if capped:
        assert (u > e_cap).any() and (u < e_cap).any()
    np.testing.assert_allclose(te, je, rtol=1e-10, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=1e-10,
                               atol=1e-10 * np.abs(jg).max())
    assert tt.dim == (22, 3) and tt.name == "forcefield"


def test_collinear_angle_gradient_differs_from_jax_only_there():
    """At a collinear a-b-c the angle's ``|u x v|`` is 0: JAX's gradient of
    the norm there is NaN, torch's ``vector_norm`` backward gives 0, so the
    port's force is finite where the JAX package's is NaN (ROADMAP C4).
    One step off the line both agree."""
    d = {"atoms": [[0.0, 0.0, 0.0]] * 3, "angles": [[0, 1, 2, 5.0, 2.0]]}
    jf, tf = _both(d)
    line = np.array([[[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]])
    bent = line + np.array([0.0, 1e-3, 0.0]) * np.array([[1], [0], [0]])
    _, jg, _, tg = _energy_and_grad(lambda p: jff.ff_energy(jf, p),
                                    lambda p: tff.ff_energy(tf, p), line)
    assert np.isnan(jg).all() and (tg == 0.0).all()
    je, jg, te, tg = _energy_and_grad(lambda p: jff.ff_energy(jf, p),
                                      lambda p: tff.ff_energy(tf, p), bent)
    np.testing.assert_allclose(te, je, rtol=1e-10)
    np.testing.assert_allclose(tg, jg, rtol=1e-10,
                               atol=1e-10 * np.abs(jg).max())


def test_dihedrals_zmatrix_and_profiles_match_jax():
    jf, tf = _both(ALA2, ALA2["coulomb_const"])
    x0 = tff.zmatrix_to_cartesian(ALA2["zmatrix"])
    np.testing.assert_array_equal(x0, jff.zmatrix_to_cartesian(
        ALA2["zmatrix"]))
    x = _ala2_positions(P=64, seed=3, jitter=0.4)
    ja = np.asarray(jax.jit(jax.vmap(lambda p: jff.dihedral_angles(jf, p)))(
        jnp.asarray(x)))
    ta = tff.dihedral_angles(tf, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-12)
    # the z-matrix's requested phi/psi (-80 and +75 degrees) come back
    phi, psi = tff.dihedral_angles(tf, torch.from_numpy(x0))[
        [ALA2["phi_torsion_index"], ALA2["psi_torsion_index"]]]
    assert np.degrees(float(phi)) == pytest.approx(-80.0, abs=1e-4)
    assert np.degrees(float(psi)) == pytest.approx(75.0, abs=1e-4)
    w = np.random.default_rng(4).random(64)
    for weights in (None, w / w.sum()):
        jc, jF = jff.free_energy_profile(ja[:, 17], 0.6, bins=12,
                                         weights=weights)
        tc, tF = tff.free_energy_profile(ta[:, 17], 0.6, bins=12,
                                         weights=weights)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(np.isinf(tF), np.isinf(jF))
        fin = np.isfinite(jF)
        np.testing.assert_allclose(tF[fin], jF[fin], rtol=1e-12, atol=1e-12)
        assert tF[fin].min() == 0.0


def test_from_dict_dtype_and_default_device():
    """The parameters take the dtype asked for (the driver passes the
    run's), and without ``device`` they go to the card: with no card that
    raises instead of falling back to the CPU."""
    f32 = tff.ForceField.from_dict(CHAIN, dtype=torch.float32, device="cpu")
    assert f32.bond_k.dtype == torch.float32
    assert f32.bond_idx.dtype == torch.int64
    e = tff.ff_energy(f32, torch.from_numpy(_chain_positions()).float())
    assert e.dtype == torch.float32
    if torch.cuda.is_available():
        assert tff.ForceField.from_dict(CHAIN).sigma.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tff.ForceField.from_dict(CHAIN)


def test_flow_vi_loss_on_ala2_matches_jax_f64():
    """The VI loss and its parameter gradients against the ala2 force field
    (e_cap 500, as vi_ala2.yaml), same base draws, converted parameters."""
    NF, H, P = 4, 8, 3
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(0), jcfg, jnp.float64)
    rng = np.random.default_rng(5)
    x0 = jff.zmatrix_to_cartesian(ALA2["zmatrix"])
    draws = {"h": rng.normal(size=(P, 22, NF)),
             "g": rng.normal(size=(P, 22, NF)),
             "pos": x0[None] + 0.1 * rng.normal(size=(P, 22, 3)),
             "vel": rng.normal(size=(P, 22, 3))}
    rest = dict(mask=np.ones((P, 22), bool), box=np.full((P, 3), 1e3),
                r_cut=np.full((P,), 1e2))
    jbatch = JSystem(**{k: jnp.asarray(v) for k, v in {**draws,
                                                       **rest}.items()})
    tbatch = System(**{k: torch.from_numpy(v.copy())
                       for k, v in {**draws, **rest}.items()})
    jf, tf = _both(ALA2, ALA2["coulomb_const"])
    jt = j_system_target(jff.forcefield_target(jf, 0.59616, 500.0).log_prob)
    tt = make_system_target(tff.forcefield_target(tf, 0.59616,
                                                  500.0).log_prob)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_flow_vi_loss(p, jcfg, jbatch, jt)[0]))(jp)
    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, _ = flow_vi_loss(tp, tcfg, tbatch, tt)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    assert np.isfinite(float(jl))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-10)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())


def test_ff_extras_match_jax_driver():
    """``_ff_extras`` of both drivers on the same positions: the dihedrals,
    and the phi/psi profiles with and without importance weights."""
    jf, tf = _both(ALA2, ALA2["coulomb_const"])
    x = _ala2_positions(P=40, seed=6, jitter=0.5)
    w = np.random.default_rng(7).random(40)
    sec = {"fe_bins": 18}
    jobj = types.SimpleNamespace(_ff=jf, _ff_params=ALA2, _ff_kBT=0.59616)
    tobj = types.SimpleNamespace(_ff=tf, _ff_params=ALA2, _ff_kBT=0.59616)
    for weights in (None, w / w.sum()):
        want = JMain._ff_extras(jobj, x, weights, sec)
        got = Main._ff_extras(tobj, torch.from_numpy(x), weights, sec)
        assert set(got) == set(want) == {
            "dihedrals", "phi_centers", "phi_free_energy", "psi_centers",
            "psi_free_energy"}
        np.testing.assert_allclose(got["dihedrals"], want["dihedrals"],
                                   rtol=0, atol=1e-12)
        for k in ("phi_centers", "psi_centers"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("phi_free_energy", "psi_free_energy"):
            fin = np.isfinite(want[k])
            np.testing.assert_array_equal(np.isfinite(got[k]), fin)
            np.testing.assert_allclose(got[k][fin], want[k][fin], rtol=1e-12,
                                       atol=1e-12)
    assert Main._ff_extras(types.SimpleNamespace(), x, None, sec) == {}
