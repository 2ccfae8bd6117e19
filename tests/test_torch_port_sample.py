"""Port parity: the sampling slice as a whole.

Deterministic (float64, tolerance 1e-9): the bench-style batched densities
(``bench.py:build_batched``) — the proposal ``reverse_core`` of numpy
latents, ``log_q0`` and ``log_p`` with their batched gradients w.r.t.
``(h, g, pos, vel)`` — and ``systematic_resample`` fed JAX's uniform.

Statistical (the two RNGs differ): the port's and JAX's ``smc`` on the same
converted tiny flow and LJ cluster agree in mean ``log_Z`` over seeds
within 4 combined standard errors, and the port's ``smc``/``ais`` recover
the exact ``log_Z`` of a Gaussian pair (the JAX package's oracle in
``tests/test_sample.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import forward_core as j_forward_core
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.flow import reverse_core as j_reverse_core
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.sample import smc as j_smc
from enflow_tpu.sample import systematic_resample as j_resample
from enflow_tpu.sample import targets as j_targets
from enflow_tpu.sample.mcmc import batched_value_and_grad as j_vg

from enflow_tpu_torch.flow import FlowConfig
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.sample import ais, smc, systematic_resample, targets
from enflow_tpu_torch.sample.mcmc import batched_value_and_grad
from enflow_tpu_torch.train.driver import flow_densities
from enflow_tpu_torch.utils.jax_params import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

N, NF, H = 4, 3, 8
KEYS = ("g", "h", "pos", "vel")


def _flow(dtype):
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs", exact_ldj=True)
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(0), jcfg, dtype)
    return jcfg, jp, FlowConfig(egcl=EGCLConfig(NF, H), **kw), \
        from_jax_params(jp, device="cpu")


def _jax_densities(jp, jcfg, cluster, dtype):
    def to_system(x):
        P = x["h"].shape[0]
        return JSystem(h=x["h"], g=x["g"], pos=x["pos"], vel=x["vel"],
                       mask=jnp.ones((P, N), bool),
                       box=jnp.full((P, 3), 1e3, dtype),
                       r_cut=jnp.full((P,), 1e2, dtype))

    def gauss(s):
        return -0.5 * sum((f * f).sum(axis=(1, 2)) for f in (s.h, s.g, s.vel))

    def log_q0(x):
        out, ldj = j_forward_core(jp, jcfg, to_system(x))
        return gauss(out) - 0.5 * (out.pos ** 2).sum(axis=(1, 2)) + ldj

    def log_p(x):
        return jax.vmap(cluster.log_prob)(x["pos"]) + gauss(to_system(x))

    def propose(z):
        s, _ = j_reverse_core(jp, jcfg, to_system(z))
        return {"h": s.h, "g": s.g, "pos": s.pos, "vel": s.vel}

    return propose, log_q0, log_p


def _latents(rng, P, dtype=np.float64):
    return {"h": rng.normal(size=(P, N, NF)).astype(dtype),
            "g": rng.normal(size=(P, N, NF)).astype(dtype),
            "pos": rng.normal(size=(P, N, 3)).astype(dtype),
            "vel": rng.normal(size=(P, N, 3)).astype(dtype)}


def test_densities_and_gradients_match_jax_f64():
    jcfg, jp, tcfg, tp = _flow(jnp.float64)
    jprop, jlq, jlp = _jax_densities(jp, jcfg,
                                     j_targets.lj_cluster(N, kBT=2.0),
                                     jnp.float64)
    tprop, tlq, tlp = flow_densities(tp, tcfg, targets.lj_cluster(N, kBT=2.0),
                                     N)
    z = _latents(np.random.default_rng(0), 6)
    jx = jprop({k: jnp.asarray(v) for k, v in z.items()})
    tx = tprop({k: torch.from_numpy(v) for k, v in z.items()})
    for k in KEYS:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                   rtol=1e-9, atol=1e-9)
    for jf, tf in ((jlq, tlq), (jlp, tlp)):
        jv, jg = j_vg(jf)(jx)
        tv, tg = batched_value_and_grad(tf)(tx)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                                   atol=1e-9)
        for k in KEYS:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-9, atol=1e-9)


def test_systematic_resample_matches_jax():
    rng = np.random.default_rng(1)
    for P in (7, 64):
        log_w = rng.normal(size=P) * 2.0
        key = jax.random.PRNGKey(P)
        want = j_resample(key, jnp.asarray(log_w))
        u = float(jax.random.uniform(key, (), jnp.float64))
        got = systematic_resample(torch.from_numpy(log_w), uniform=u)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_smc_log_z_agrees_with_jax():
    """Mean log_Z over 6 seeds per package, within 4 combined SEs."""
    jcfg, jp, tcfg, tp = _flow(jnp.float64)
    cluster_kw = dict(kBT=2.0, softening=0.5)
    jprop, jlq, jlp = _jax_densities(
        jp, jcfg, j_targets.lj_cluster(N, **cluster_kw), jnp.float64)
    tprop, tlq, tlp = flow_densities(
        tp, tcfg, targets.lj_cluster(N, **cluster_kw), N)
    P = 64
    knobs = dict(n_temps=4, mcmc_steps=1, step_size=0.05, n_leapfrog=3)

    @jax.jit
    def jrun(key):
        kz, ks = jax.random.split(key)
        ks4 = jax.random.split(kz, 4)
        z = {k: jax.random.normal(kk, (P, N, NF if k in ("h", "g") else 3),
                                  jnp.float64)
             for k, kk in zip(KEYS, ks4)}
        return j_smc(ks, jprop(z), log_q0=jlq, log_p=jlp, batched=True,
                     **knobs).log_Z

    jz = np.array([float(jrun(jax.random.PRNGKey(s))) for s in range(6)])
    tz = []
    for s in range(6):
        gen = torch.Generator().manual_seed(100 + s)
        z = {k: torch.randn((P, N, NF if k in ("h", "g") else 3),
                            generator=gen, dtype=torch.float64)
             for k in KEYS}
        tz.append(float(smc(gen, tprop(z), log_q0=tlq, log_p=tlp,
                            **knobs).log_Z))
    tz = np.array(tz)
    assert np.isfinite(jz).all() and np.isfinite(tz).all()
    se = math.sqrt(jz.var(ddof=1) / len(jz) + tz.var(ddof=1) / len(tz))
    assert abs(jz.mean() - tz.mean()) < 4 * se, (jz, tz)


@pytest.mark.parametrize("algo", [smc, ais])
def test_annealing_gaussian_log_z(algo):
    """Anneal N(0,1) -> N(0, 0.5^2) in d=3: log(Z_p/Z_q) = 3 log(0.5)."""
    d, P = 3, 512
    gen = torch.Generator().manual_seed(6)
    x0 = torch.randn((P, d), generator=gen, dtype=torch.float64)
    res = algo(gen, x0, log_q0=lambda x: -0.5 * (x ** 2).sum(-1),
               log_p=lambda x: -0.5 * (x ** 2).sum(-1) / 0.25,
               n_temps=12, mcmc_steps=2, step_size=0.3, n_leapfrog=5)
    assert float(res.log_Z) == pytest.approx(d * math.log(0.5), abs=0.1)
    w = torch.softmax(res.log_weights, dim=0)
    var = float((w[:, None] * res.particles ** 2).sum()) / d
    assert var == pytest.approx(0.25, rel=0.2)
    assert torch.isfinite(res.ess_history).all()
