"""Port parity: the pair-energy kernel's contract (K7), the MD built on it,
and the LJ dataset's host-side draws.

- The plain PyTorch version of the CUDA kernel's contract
  (``enflow_tpu_torch.ops.pair_energy``, what a CPU tensor runs) against
  ``pallas_lj_potential`` (form r2) and ``pallas_softened_lj_energy``
  (form r) of ``enflow_tpu/ops/pairwise_kernel.py`` in interpret mode,
  energy and gradient at f32 (rtol 1e-5: summation order only), with
  padded atoms, a coincident pair, several column tiles (``TILE`` shrunk
  with ``monkeypatch``) and PBC.
- ``softened_lj_energy`` against the JAX package's dense form at float64,
  also with two coincident atoms (counted at softening > 0, left out at
  0; their force is 0 where ``jax.grad`` gives NaN), and the kernel's
  plain version with its ``coincident`` flag off (the Pallas contract).
- MD at float64: 50 FIRE steps (1e-9) and one Langevin-middle step with
  the JAX package's noise fed in (1e-12); a short port ``simulate`` holds
  the mean instantaneous temperature within 10% of the target.
- ``LJDataset`` with one seed gives the JAX package's grid, ``g`` features
  and frame count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data import transforms as JT
from enflow_tpu.data.lj import LJDataset as JLJDataset
from enflow_tpu.data.lj import arrange_points_on_grid as j_grid
from enflow_tpu.ops import pairwise_kernel as pk
from enflow_tpu.sim import integrate as jint
from enflow_tpu.sim.potentials import softened_lj_energy as j_softened

from enflow_tpu_torch.data import transforms as TT
from enflow_tpu_torch.data.lj import LJDataset, arrange_points_on_grid
from enflow_tpu_torch.ops import pair_energy as ops
from enflow_tpu_torch.sim import integrate as tint
from enflow_tpu_torch.sim.potentials import (softened_lj_energy,
                                             softened_lj_energy_grad)
from torch_threads import one_torch_thread  # noqa: F401


def _batch(seed, B, N, n_pad=0, spread=1.5):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, N, 3)) * spread
    mask = np.ones((B, N), bool)
    if n_pad:
        mask[0, N - n_pad:] = False
        pos[0, N - n_pad:] = 0.0
    pos[-1, 1] = pos[-1, 0]                       # coincident: left out
    return pos.astype(np.float32), mask


def _grad(f, x):
    return np.asarray(jax.grad(lambda p: f(p).sum())(x))


@pytest.mark.parametrize("tile,N,n_pad", [(512, 9, 2), (16, 40, 5)])
def test_r2_matches_pallas_f32(monkeypatch, tile, N, n_pad):
    monkeypatch.setattr(pk, "TILE", tile)
    pos, mask = _batch(N, 3, N, n_pad)
    jm = jnp.asarray(mask)
    f = lambda p: pk.pallas_lj_potential(p, jm, 0.1)
    je, jg = np.asarray(f(jnp.asarray(pos))), _grad(f, jnp.asarray(pos))
    tp = torch.from_numpy(pos).requires_grad_(True)
    ops.counts.reset()
    te = ops.pair_energy(tp, torch.from_numpy(mask), None, "r2", 0.1)
    tg, = torch.autograd.grad(te.sum(), tp)
    assert ops.counts.plain_calls == 1 and ops.counts.r2_launches == 0
    np.testing.assert_allclose(te.detach().numpy(), je, rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    assert float(tg[0, N - n_pad:].abs().max()) == 0.0


@pytest.mark.parametrize("tile,N", [(512, 13), (16, 37)])
def test_r_matches_pallas_f32(monkeypatch, tile, N):
    monkeypatch.setattr(pk, "TILE", tile)
    rng = np.random.default_rng(N)
    box = np.array([5.0, 5.0, 5.0], np.float32)
    pos = rng.uniform(-2.5, 2.5, size=(N, 3)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[-2:] = False
    jb, jm = jnp.asarray(box), jnp.asarray(mask)
    f = lambda p: pk.pallas_softened_lj_energy(p, jb, 0.1, 3.0, mask=jm)
    je, jg = float(f(jnp.asarray(pos))), _grad(f, jnp.asarray(pos))
    tp = torch.from_numpy(pos).requires_grad_(True)
    te = softened_lj_energy(tp, torch.from_numpy(box), 0.1, 3.0,
                            mask=torch.from_numpy(mask))
    tg, = torch.autograd.grad(te, tp)
    assert float(te.detach()) == pytest.approx(je, rel=1e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def test_softened_matches_dense_jax_f64():
    rng = np.random.default_rng(7)
    box = np.array([4.0, 4.5, 5.0])
    pos = rng.uniform(-2.0, 2.0, size=(11, 3))
    jb = jnp.asarray(box)
    f = lambda p: j_softened(p, jb, 0.1, 2.5)
    je, jg = float(f(jnp.asarray(pos))), np.asarray(jax.grad(f)(
        jnp.asarray(pos)))
    te, tg = softened_lj_energy_grad(torch.from_numpy(pos),
                                     torch.from_numpy(box), 0.1, 2.5)
    assert float(te) == pytest.approx(je, rel=1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-10, atol=1e-12)


def _coincident_trio():
    """Two coincident atoms and a third, in a 5-sigma box."""
    return np.array([[0.3, -0.2, 0.1], [0.3, -0.2, 0.1], [1.4, 0.6, -0.7]])


def test_softened_counts_coincident_pairs_as_jax_f64():
    box = np.array([5.0, 5.0, 5.0])
    pos = _coincident_trio()
    jb, tb = jnp.asarray(box), torch.from_numpy(box)
    je = float(j_softened(jnp.asarray(pos), jb, 0.1, 3.0))
    te = softened_lj_energy(torch.from_numpy(pos), tb, 0.1, 3.0)
    te2, tg = softened_lj_energy_grad(torch.from_numpy(pos), tb, 0.1, 3.0)
    assert float(te) == pytest.approx(je, rel=1e-12)
    assert float(te2) == pytest.approx(je, rel=1e-12)
    # the coincident pair holds 4(s^-12 - s^-6) of it
    far = float(j_softened(jnp.asarray(pos[1:]), jb, 0.1, 3.0))
    assert je - 2 * far == pytest.approx(4.0 * (0.1 ** -12 - 0.1 ** -6),
                                         rel=1e-12)
    # jax.grad through sqrt(0) gives NaN at the coincident pair; the port
    # gives that pair no force, so each atom feels the third one only
    jg = np.asarray(jax.grad(lambda p: j_softened(p, jb, 0.1, 3.0))(
        jnp.asarray(pos)))
    assert np.isnan(jg[:2]).all()
    _, g_far = softened_lj_energy_grad(torch.from_numpy(pos[1:]), tb, 0.1,
                                       3.0)
    np.testing.assert_allclose(tg[:2].numpy(), g_far[:1].expand(2, 3),
                               rtol=1e-12)
    np.testing.assert_allclose(tg[2].numpy(), 2 * g_far[1].numpy(),
                               rtol=1e-12)
    # at softening 0 the pair is left out, as before
    t0 = softened_lj_energy(torch.from_numpy(pos), tb, 0.0, 3.0)
    f0 = softened_lj_energy(torch.from_numpy(pos[1:]), tb, 0.0, 3.0)
    assert float(t0) == pytest.approx(2 * float(f0), rel=1e-12)
    # (where the dense form gives inf - inf = NaN)
    assert np.isnan(float(j_softened(jnp.asarray(pos), jb, 0.0, 3.0)))


def test_plain_without_flag_keeps_the_pallas_contract():
    """Flag off, the plain version drops the coincident pair, as
    ``pallas_softened_lj_energy`` does (``pairwise_kernel.py:90``)."""
    box = np.array([5.0, 5.0, 5.0], np.float32)
    pos = _coincident_trio().astype(np.float32)
    je = float(pk.pallas_softened_lj_energy(jnp.asarray(pos),
                                            jnp.asarray(box), 0.1, 3.0))
    args = (torch.from_numpy(pos)[None], torch.ones((1, 3)),
            torch.from_numpy(box)[None], "r", 0.1, 3.0)
    e_off, _ = ops.pair_energy_and_grad(*args)
    e_on, g_on = ops.pair_energy_and_grad(*args, coincident=True)
    assert float(e_off[0]) == pytest.approx(je, rel=1e-5)
    assert float(e_on[0] - e_off[0]) == pytest.approx(
        4.0 * (0.1 ** -12 - 0.1 ** -6), rel=1e-5)
    assert torch.isfinite(g_on).all()


# --- MD -------------------------------------------------------------------

BOX = np.array([5.0, 5.0, 5.0])


def _md_state(n=8, seed=0):
    grid = arrange_points_on_grid(n, BOX, 1.0) - BOX / 2
    rng = np.random.default_rng(seed)
    return grid + 0.05 * rng.normal(size=grid.shape)


def _energy_grad(box_t):
    return lambda p: softened_lj_energy_grad(p, box_t, 0.1, 3.0)


def test_fire_matches_jax_f64():
    pos0 = _md_state()
    jb = jnp.asarray(BOX)
    want = jint.minimize_fire(jnp.asarray(pos0),
                              lambda p: j_softened(p, jb, 0.1, 3.0),
                              n_steps=50, box=jb)
    box_t = torch.from_numpy(BOX)
    got = tint.minimize_fire(torch.from_numpy(pos0), _energy_grad(box_t),
                             n_steps=50, box=box_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)


def test_langevin_step_matches_jax_f64():
    pos0 = _md_state(seed=1)
    vel0 = np.random.default_rng(2).normal(size=pos0.shape)
    jb = jnp.asarray(BOX)
    key = jax.random.PRNGKey(5)
    force = jax.grad(lambda p: -j_softened(p, jb, 0.1, 3.0))
    st = jint.langevin_middle_step(
        jint.MDState(jnp.asarray(pos0), jnp.asarray(vel0), key), force,
        0.005, 1.0, 1.2, box=jb)
    noise = jax.random.normal(jax.random.split(key)[0], vel0.shape,
                              jnp.float64)
    box_t = torch.from_numpy(BOX)
    pos, vel = tint.langevin_middle_step(
        torch.from_numpy(pos0), torch.from_numpy(vel0), _energy_grad(box_t),
        0.005, 1.0, 1.2, torch.from_numpy(np.array(noise)), box=box_t)
    np.testing.assert_allclose(pos.numpy(), np.asarray(st.pos), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(vel.numpy(), np.asarray(st.vel), rtol=0,
                               atol=1e-12)


def test_simulate_holds_temperature():
    box = np.array([4.0, 4.0, 4.0])
    box_t = torch.from_numpy(box)
    eg = _energy_grad(box_t)
    grid = torch.from_numpy(arrange_points_on_grid(27, box, 0.5) - box / 2)
    pos = tint.minimize_fire(grid, eg, n_steps=50, box=box_t)
    gen = torch.Generator().manual_seed(0)
    vel = tint.thermalize(gen, 27, 1.0, dtype=torch.float64)
    frames = tint.simulate(gen, pos, vel, eg, n_steps=400, interval=4,
                           dt=0.005, friction=10.0, kBT=1.0, box=box_t)
    assert frames["pos"].shape == (100, 27, 3)
    assert frames["step"][-1] == 400
    assert float(frames["kBT_inst"].mean()) == pytest.approx(1.0, rel=0.1)
    assert torch.isfinite(frames["pe"]).all()


def test_lj_dataset_host_draws_match_jax():
    kw = dict(n_atoms=6, box=[12.0, 12.0, 12.0], temp=120.0, softening=0.1,
              n_iter=40, interval=10, discard=20, dt=0.004, friction=1.0,
              dist_unit="ang", time_unit="pico", minimize_steps=10, seed=3,
              r_cut=6.0)
    jt = JT.Compose([JT.ConvertPositionsFrom("ang"), JT.Center(),
                     JT.ConvertVelocitiesFrom("ang", "pico")])
    tt = TT.Compose([TT.ConvertPositionsFrom("ang"), TT.Center(),
                     TT.ConvertVelocitiesFrom("ang", "pico")])
    jd = JLJDataset(transform=jt, **kw)
    td = LJDataset(transform=tt, device="cpu", **kw)
    np.testing.assert_array_equal(arrange_points_on_grid(6, [3.0] * 3, 0.3),
                                  j_grid(6, [3.0] * 3, 0.3))
    assert len(td) == len(jd) == 3
    for a, b in zip(td.samples, jd.samples):
        np.testing.assert_array_equal(a.g, b.g)
        np.testing.assert_array_equal(a.h, b.h)
        assert a.label == b.label and a.z == b.z
        assert a.r_cut == b.r_cut
        np.testing.assert_array_equal(a.box, b.box)
        assert np.isfinite(a.pos).all() and np.isfinite(a.vel).all()
