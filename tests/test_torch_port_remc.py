"""Port parity: replica exchange (``sample/remc.py``), MBAR
(``sample/mbar.py``).

- The swap phase, exact: the JAX package's ``remc`` at ``mcmc_steps=0``
  over 20 rounds against the port's ``swap_phase`` fed the same uniforms
  (``uniform(fold_in(fold_in(key, r), 7919), (K-1, M))``): the identical
  permutation of states each round, the caches moved with their states,
  and the same per-pair rates (counted over the rounds a pair was on).
- REMC statistics: Gaussian moments of the beta=1 slot (the JAX test's
  tolerances), the bridged family, and ``remc_segments`` bitwise equal to
  ``remc``, also when resumed from a captured state.
- MBAR, float64: ``(f, log_w, converged)`` against the JAX package on the
  same ``u_kn`` at 1e-10, ``mbar_block_log_z`` equal, ``mbar_from_remc``'s
  potentials.

The driver's ``algo: remc``: ``test_torch_port_remc_driver.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu_torch.sample import mbar as tmbar
from enflow_tpu_torch.sample import remc as tremc

# the JAX package's sample/__init__ exports functions of these names
jmbar = importlib.import_module("enflow_tpu.sample.mbar")
jremc = importlib.import_module("enflow_tpu.sample.remc")


def _log_p_one(x):
    return -0.5 * (x ** 2).sum() - 0.2 * (x ** 4).sum()


def _log_q0_one(x):
    return -0.5 * ((x - 0.3) ** 2).sum() / 1.7


def _log_p(x):
    return -0.5 * (x ** 2).sum(-1) - 0.2 * (x ** 4).sum(-1)


def _log_q0(x):
    return -0.5 * ((x - 0.3) ** 2).sum(-1) / 1.7


def test_swap_phase_replays_jax_permutations():
    K, M, R = 5, 16, 20
    betas = np.array([0.0, 0.1, 0.3, 0.6, 1.0])
    x0 = np.random.default_rng(0).normal(size=(K, M, 3)) * 1.5
    key = jax.random.PRNGKey(3)
    jres = jremc.remc(key, jnp.asarray(x0), log_p=_log_p_one,
                      log_q0=_log_q0_one, betas=jnp.asarray(betas),
                      n_rounds=R, mcmc_steps=0)
    state = tremc._init_remc_caches(_log_q0, _log_p, torch.from_numpy(x0))
    tb = torch.from_numpy(betas)
    rates, ons, samples = [], [], []
    for r in range(R):
        k_swap = jax.random.fold_in(jax.random.fold_in(key, r), 7919)
        u = jax.random.uniform(k_swap, (K - 1, M), jnp.float64)
        state, rate, on = tremc.swap_phase(r % 2, torch.from_numpy(
            np.array(u)), state, tb)
        rates.append(rate)
        ons.append(on)
        samples.append(state[0][-1])
        np.testing.assert_array_equal(samples[-1].numpy(),
                                      np.asarray(jres.samples[r]))
    np.testing.assert_array_equal(state[0].numpy(),
                                  np.asarray(jres.x_final))
    moved = (state[0].numpy() != x0).any()
    assert moved
    # the caches moved with their states
    x, lq0, lp, glq0, glp = state
    np.testing.assert_allclose(lq0.numpy(), _log_q0(x).numpy(), rtol=1e-12)
    np.testing.assert_allclose(lp.numpy(), _log_p(x).numpy(), rtol=1e-12)
    np.testing.assert_allclose(glp.numpy(), (-x - 0.8 * x ** 3).numpy(),
                               rtol=1e-12)
    agg = tremc._aggregate(state[0], (torch.stack(samples),
                                      torch.zeros((R, K)),
                                      torch.stack(rates), torch.stack(ons)),
                           tb)
    np.testing.assert_allclose(agg.swap_accept.numpy(),
                               np.asarray(jres.swap_accept), rtol=1e-12)


def test_remc_gaussian_moments_and_segments():
    """A plain temperature ladder on N(0, 1) in d=2 (the JAX test's
    tolerances); the chunked run equals the monolithic one bit for bit,
    also resumed from a captured segment."""
    K, M = 4, 256
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((K, M, 2), generator=gen, dtype=torch.float64) * 0.5
    lp = lambda x: -0.5 * (x ** 2).sum(-1)
    kw = dict(log_p=lp, betas=[0.1, 0.3, 0.6, 1.0], n_rounds=120,
              step_size=[1.0, 0.8, 0.6, 0.5], n_leapfrog=5)
    res = tremc.remc(torch.Generator().manual_seed(3), x0, **kw)
    s = res.samples[30:].numpy()
    assert abs(s.mean()) < 0.05
    assert s.var() == pytest.approx(1.0, rel=0.1)
    assert (res.swap_accept.numpy() > 0.2).all()
    assert ((res.accept.numpy() > 0.3) & (res.accept.numpy() <= 1.0)).all()
    seen = []
    seg = tremc.remc_segments(
        torch.Generator().manual_seed(3), x0, chunk_rounds=50,
        on_segment=lambda r, st, outs: seen.append((r, st, list(outs))),
        **kw)
    assert [r for r, _, _ in seen] == [50, 100, 120]
    for a, b in ((seg.samples, res.samples), (seg.x_final, res.x_final),
                 (seg.swap_accept, res.swap_accept),
                 (seg.accept, res.accept)):
        assert torch.equal(a, b)
    r0, st, outs = seen[1]
    resumed = tremc.remc_segments(torch.Generator().manual_seed(3), None,
                                  chunk_rounds=50, start_round=r0,
                                  init_state=st, init_outs=outs, **kw)
    assert torch.equal(resumed.samples, res.samples)


def test_tile_replicas_matches_jax():
    x = {"pos": np.random.default_rng(9).normal(size=(4, 3, 3))}
    want = jremc.tile_replicas(jax.tree_util.tree_map(jnp.asarray, x), 3)
    got = tremc.tile_replicas({"pos": torch.from_numpy(x["pos"])}, 3)
    np.testing.assert_array_equal(got["pos"].numpy(),
                                  np.asarray(want["pos"]))
    got["pos"][0, 0, 0, 0] = 7.0             # replicas are copies
    assert got["pos"][1, 0, 0, 0] != 7.0


def test_remc_bridged_family_matches_target():
    """The flow-bridged ladder from beta=0 (log_q0 a wide Gaussian) to
    N(0, 0.5^2): the beta=1 slot's variance."""
    K, M = 5, 256
    gen = torch.Generator().manual_seed(4)
    x0 = torch.randn((K, M, 3), generator=gen, dtype=torch.float64) * 1.5
    res = tremc.remc(gen, x0, log_p=lambda x: -2.0 * (x ** 2).sum(-1),
                     log_q0=lambda x: -0.5 * (x ** 2).sum(-1) / 2.25,
                     betas=[0.0, 0.25, 0.5, 0.75, 1.0], n_rounds=100,
                     step_size=0.3, n_leapfrog=5)
    s = res.samples[30:].numpy()
    assert s.var() == pytest.approx(0.25, rel=0.12)
    assert (res.swap_accept.numpy() > 0.1).all()


def test_mbar_matches_jax_f64():
    rng = np.random.default_rng(5)
    K, n = 4, 30
    means = np.array([0.0, 0.5, 1.0, 1.5])
    xs = np.concatenate([rng.normal(m, 1.0, n) for m in means])
    u_kn = 0.5 * (xs[None, :] - means[:, None]) ** 2 + np.array(
        [0.0, 0.3, -0.2, 0.7])[:, None]
    counts = np.full(K, n)
    want = jmbar.mbar(jnp.asarray(u_kn), jnp.asarray(counts), n_iter=300)
    got = tmbar.mbar(torch.from_numpy(u_kn), torch.from_numpy(counts),
                     n_iter=300)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(want.f), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(got.log_w.numpy(), np.asarray(want.log_w),
                               rtol=1e-10, atol=1e-10)
    assert float(got.converged) == pytest.approx(float(want.converged),
                                                 rel=1e-6, abs=1e-14)
    states = np.repeat(np.arange(K), n)
    columns = np.tile(np.arange(n), K)
    jb = jmbar.mbar_block_log_z(jnp.asarray(u_kn), states, columns, K,
                                n_blocks=3, n_iter=200)
    tb = tmbar.mbar_block_log_z(torch.from_numpy(u_kn), states, columns, K,
                                n_blocks=3, n_iter=200)
    np.testing.assert_allclose(tb, jb, rtol=1e-10, atol=1e-10)


def test_mbar_from_remc_matches_jax():
    K, M = 3, 8
    betas = np.array([0.0, 0.5, 1.0])
    x = np.random.default_rng(6).normal(size=(K, M, 2))
    jres = jremc.REMCResult(samples=None, x_final=jnp.asarray(x),
                            swap_accept=None, accept=None,
                            betas=jnp.asarray(betas))
    tres = tremc.REMCResult(samples=None, x_final=torch.from_numpy(x),
                            swap_accept=None, accept=None,
                            betas=torch.from_numpy(betas))
    ju, jc = jmbar.mbar_from_remc(jres, _log_p_one, _log_q0_one)
    tu, tc = tmbar.mbar_from_remc(tres, _log_p, _log_q0)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-12)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
