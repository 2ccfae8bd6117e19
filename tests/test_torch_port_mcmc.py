"""Port parity: the per-chain samplers (``sample/mcmc.py``,
``sample/nuts.py``).

Exact where the draws can be replayed: the JAX kernels' draws are computed
from their keys with ``jax.random`` (``_tree_randn_like(kmom, x)``,
``uniform(kacc)``) and fed to the port's kernel cores, which must give the
same positions (1e-10, float64) and the same accept decisions as
``hmc_kernel``, ``mala_kernel`` and ``tempered_hmc_kernel_batched``
(scalar and per-particle beta / step size, with and without a mass).
NUTS's bit helpers, ``_uturn`` and ``_leapfrog`` are held exactly.

Statistical where they cannot (the RNGs differ), at the JAX package's own
tolerances (``tests/test_nuts.py``): NUTS moments on a correlated Gaussian
and its divergence detection and warmup recovery; ``run_hmc``,
``run_mala`` and ``dual_averaging_warmup`` moments.

The driver's ``algo: hmc | mala | nuts``: ``test_torch_port_mcmc_driver.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.sample import mcmc as jm
from enflow_tpu.sample import nuts as jn

from enflow_tpu_torch.sample import mcmc as tm
from enflow_tpu_torch.sample import nuts as tn
from torch_threads import one_torch_thread  # noqa: F401

C = 12


def _log_prob_one(x):
    """A non-Gaussian density of one chain state {a: [3], b: [2]}."""
    a, b = x["a"], x["b"]
    return (-0.5 * (a ** 2).sum() - 0.25 * (b ** 4).sum()
            + 0.3 * a[0] * b[0] - 0.1 * (a[1] * b[1]) ** 2)


def _log_prob_batched(x):
    a, b = x["a"], x["b"]
    return (-0.5 * (a ** 2).sum(-1) - 0.25 * (b ** 4).sum(-1)
            + 0.3 * a[:, 0] * b[:, 0] - 0.1 * (a[:, 1] * b[:, 1]) ** 2)


def _state(seed=0, scale=1.5):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(C, 3)) * scale,
            "b": rng.normal(size=(C, 2)) * scale}


def _jax(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _torch(x):
    return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}


def _per_chain_draws(keys, x):
    """JAX's draws of a per-chain kernel: momenta (or noise) from the first
    half of each chain's key, the acceptance uniform from the second."""
    def one(k, xc):
        k1, k2 = jax.random.split(k)
        return jm._tree_randn_like(k1, xc), jax.random.uniform(k2)
    return jax.vmap(one)(keys, _jax(x))


@pytest.mark.parametrize("step,n_lf", [(0.3, 4), (0.9, 3)])
def test_hmc_kernel_replays_jax_draws(step, n_lf):
    x = _state()
    keys = jax.random.split(jax.random.PRNGKey(1), C)
    jx, jacc, jlp = jax.vmap(lambda k, xc: jm.hmc_kernel(
        k, xc, _log_prob_one, step, n_lf))(keys, _jax(x))
    p0, u = _per_chain_draws(keys, x)
    vg = tm.batched_value_and_grad(_log_prob_batched)
    tx, tacc, tlp, tg = tm.hmc_step(_torch(x), _torch(p0),
                                    torch.from_numpy(np.array(u)), vg, step,
                                    n_lf)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    if step > 0.5:
        assert 0 < int(tacc.sum()) < C         # both decisions occur
    for k in x:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-10)
    # the carried gradient is the gradient at the returned state
    _, g = vg(tx)
    for k in x:
        np.testing.assert_allclose(tg[k].numpy(), g[k].numpy(), rtol=1e-12)
    _check_wrapper(tm.hmc_kernel, tm.hmc_step, x, (step, n_lf))


def _check_wrapper(kernel, step_fn, x, args):
    """The generator wrapper draws the momenta (or noise), then one
    uniform a chain, and runs the core on them."""
    got = kernel(torch.Generator().manual_seed(9), _torch(x),
                 _log_prob_batched, *args)
    gen = torch.Generator().manual_seed(9)
    draws = tm.randn_like(gen, _torch(x))
    u = torch.rand((C,), generator=gen, dtype=torch.float64)
    want = step_fn(_torch(x), draws, u,
                   tm.batched_value_and_grad(_log_prob_batched), *args)
    assert torch.equal(got[1], want[1])
    for k in x:
        assert torch.equal(got[0][k], want[0][k])


@pytest.mark.parametrize("step", [0.05, 0.4])
def test_mala_kernel_replays_jax_draws(step):
    x = _state(seed=2)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    jx, jacc = jax.vmap(lambda k, xc: jm.mala_kernel(
        k, xc, _log_prob_one, step))(keys, _jax(x))
    noise, u = _per_chain_draws(keys, x)
    tx, tacc, _, _ = tm.mala_step(
        _torch(x), _torch(noise), torch.from_numpy(np.array(u)),
        tm.batched_value_and_grad(_log_prob_batched), step)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    if step > 0.1:
        assert 0 < int(tacc.sum()) < C
    for k in x:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                   rtol=1e-10, atol=1e-10)
    _check_wrapper(tm.mala_kernel, tm.mala_step, x, (step,))


@pytest.mark.parametrize("vector,mass", [(False, False), (True, False),
                                         (True, True)])
def test_tempered_kernel_replays_jax_draws(vector, mass):
    """The batched tempered kernel (SMC, REMC's flattened ladder with
    per-particle beta and step size, TI's preconditioned form)."""
    x = _state(seed=4)

    def log_q0(x):
        return -0.5 * sum((v ** 2).sum(-1) for v in x.values())

    rng = np.random.default_rng(5)
    beta = rng.uniform(0.1, 1.0, C) if vector else 0.6
    step = rng.uniform(0.2, 0.9, C) if vector else 0.5
    m = ({"a": np.array([0.5, 1.0, 2.0]), "b": np.array([1.5, 0.7])}
         if mass else None)
    jvgq, jvgp = (jm.batched_value_and_grad(f)
                  for f in (log_q0, _log_prob_batched))
    tvgq, tvgp = (tm.batched_value_and_grad(f)
                  for f in (log_q0, _log_prob_batched))
    jvals, jgrads = zip(jvgq(_jax(x)), jvgp(_jax(x)))
    tvals, tgrads = zip(tvgq(_torch(x)), tvgp(_torch(x)))
    key = jax.random.PRNGKey(6)
    jb, js = (jnp.asarray(v) for v in (beta, step))
    jx, jacc, jv, _ = jm.tempered_hmc_kernel_batched(
        key, _jax(x), jvgq, jvgp, jb, js, 4, jvals, jgrads,
        mass=None if m is None else _jax(m))
    kmom, kacc = jax.random.split(key)
    p0 = jm._tree_randn_like(kmom, _jax(x))
    u = jax.random.uniform(kacc, (C,), jnp.float64)
    tb, ts = (torch.as_tensor(v, dtype=torch.float64) for v in (beta, step))
    tx, tacc, tv, _ = tm.tempered_hmc_step(
        _torch(x), _torch(p0), torch.from_numpy(np.array(u)), tvgq, tvgp,
        tb, ts, 4, tvals, tgrads, mass=None if m is None else _torch(m))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    for k in x:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                   rtol=1e-10, atol=1e-10)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)


def test_nuts_helpers_match_jax():
    ns = jnp.arange(70, dtype=jnp.int32)
    ones = jax.jit(jax.vmap(jn._count_trailing_ones))(ns)
    zeros = jax.jit(jax.vmap(jn._count_trailing_zeros))(ns)
    assert [tn._count_trailing_ones(n) for n in range(70)] == ones.tolist()
    assert [tn._count_trailing_zeros(n) for n in range(70)] == zeros.tolist()
    rng = np.random.default_rng(7)
    ps = rng.normal(size=(64, 3, 5))
    want = [bool(jn._uturn(*(jnp.asarray(v) for v in p))) for p in ps]
    got = tn._uturn(*(torch.from_numpy(ps[:, i]) for i in range(3)))
    assert got.tolist() == want and 0 < sum(want) < 64
    prec = rng.normal(size=(5, 5))
    prec = prec @ prec.T + np.eye(5)
    q, p = rng.normal(size=(2, 5))
    jglp = lambda v: -jnp.asarray(prec) @ v
    tglp = lambda v: -torch.from_numpy(prec) @ v
    jq, jp, jg = jn._leapfrog(jglp, jnp.asarray(q), jnp.asarray(p), 0.1,
                              jglp(jnp.asarray(q)))
    tq, tp, tg = tn._leapfrog(tglp, torch.from_numpy(q), torch.from_numpy(p),
                              0.1, tglp(torch.from_numpy(q)))
    for a, b in ((tq, jq), (tp, jp), (tg, jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)


def test_nuts_correlated_gaussian_moments():
    """``tests/test_nuts.py``'s case and tolerances."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.from_numpy(np.linalg.inv(cov))
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn((48, 2), generator=gen, dtype=torch.float64)
    res = tn.run_nuts(gen, x0, lambda q: -0.5 * ((q @ prec) * q).sum(-1),
                      n_samples=250, n_warmup=60, step_size=0.25,
                      max_depth=8)
    assert float(res.divergence_rate) < 0.01
    s = res.samples.reshape(-1, 2).numpy()
    assert np.abs(s.mean(0)).max() < 0.1
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.15)
    assert float(res.mean_depth) >= 1.0
    # chains stop at their own depths: not all at one
    _, info = tn.nuts_kernel(gen, res.final_state,
                             lambda q: -0.5 * ((q @ prec) * q).sum(-1), 0.25)
    assert len(set(info["depth"].tolist())) > 1


def test_nuts_divergence_detection_and_warmup_recovery():
    log_prob = lambda q: -0.5 * (q ** 2).sum(-1) * 1e4
    _, info = tn.nuts_kernel(torch.Generator().manual_seed(0),
                             torch.ones((1, 2), dtype=torch.float64),
                             log_prob, 1.0)
    assert bool(info["diverging"][0])
    x0 = torch.full((8, 2), 0.02, dtype=torch.float64)
    res = tn.run_nuts(torch.Generator().manual_seed(2), x0, log_prob,
                      n_samples=100, n_warmup=120, step_size=0.5,
                      max_depth=6)
    assert float(res.divergence_rate) < 0.05
    assert float(res.samples.std()) == pytest.approx(1e-2, rel=0.3)


def test_run_hmc_mala_and_dual_averaging_moments():
    """N(mu, diag(s^2)) in d=3 from a cold start: the kept sweeps' moments,
    the adapted step's acceptance near its target, and the warmup
    discarded."""
    mu = torch.tensor([0.5, -1.0, 2.0], dtype=torch.float64)
    s = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)
    log_prob = lambda x: -0.5 * (((x - mu) / s) ** 2).sum(-1)
    gen = torch.Generator().manual_seed(8)
    x0 = torch.randn((64, 3), generator=gen, dtype=torch.float64) * 3.0
    eps, xw = tm.dual_averaging_warmup(gen, x0, log_prob, n_adapt=150,
                                       n_leapfrog=5, target_accept=0.75,
                                       init_step_size=0.05)
    assert 0.1 < float(eps) < 2.0
    res = tm.run_hmc(gen, xw, log_prob, n_samples=150, n_warmup=20,
                     step_size=float(eps), n_leapfrog=5, thin=2)
    assert res.samples.shape == (150, 64, 3)
    assert float(res.accept_rate) == pytest.approx(0.75, abs=0.15)
    draws = res.samples.reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0).numpy(), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(draws.std(0).numpy(), s.numpy(), rtol=0.12)
    assert torch.equal(res.final_state, res.samples[-1])
    mres = tm.run_mala(gen, xw, log_prob, n_samples=300, n_warmup=100,
                       step_size=0.1, thin=3)
    assert 0.5 < float(mres.accept_rate) < 1.0
    draws = mres.samples[100:].reshape(-1, 3)
    np.testing.assert_allclose(draws.mean(0).numpy(), mu.numpy(), atol=0.25)
    np.testing.assert_allclose(draws.std(0).numpy(), s.numpy(), rtol=0.2)
