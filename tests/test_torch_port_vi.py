"""Port parity: flow-VI training (``objective: flow_vi``).

Inputs (latent draws, positions, gradients) are made with numpy from a seed
and fed to both packages; parameters are carried across with
``from_jax_params`` or a checkpoint.

- ``lj_cluster`` with softening / energy-cap overrides against the JAX
  target with traced overrides, float64 values and position gradients at
  1e-12 relative, a coincident pair at softening 0 included.
- ``flow_vi_loss`` and every parameter gradient against
  ``jax.value_and_grad`` on the same base batch, float64 at 1e-9 (of each
  array's max) with ``stl`` off and on, at N=4 and at LJ55's N=55; and
  at float32 through the all-pairs kernel's plain version against the
  Pallas kernel in interpret
  mode (``use_pallas: v3``), 2e-4 of each array's max (float32 round-off
  through two flow steps, the LJ target and the sums over the edges).
- The anneal schedules of ``example/vi_lj13.yaml`` at epochs 0, 25, 50, 60
  and of ``example/vi_lj55.yaml`` (constant cap) at epochs 0 to 39.
- The optimizer chain against ``optax.chain(stateless nan_to_num,
  clip_by_global_norm, adam)`` over 3 steps with NaN and inf gradients
  (1e-10, as the NLL optimizer's test).
- VI checkpoints both ways with the JAX driver, and the port's driver end
  to end on the CPU: epoch lines, the metrics CSV, and a resumed run that
  ends where an uninterrupted one does.
"""

import csv
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.sample import targets as j_targets
from enflow_tpu.sample.vi import flow_vi_loss as j_flow_vi_loss
from enflow_tpu.sample.vi import make_base_log_prob as j_base_log_prob
from enflow_tpu.sample.vi import make_system_target as j_system_target
from enflow_tpu.train.driver import Main as JMain

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import egcl_allpairs as ops
from enflow_tpu_torch.sample import targets
from enflow_tpu_torch.sample.vi import (flow_vi_loss, make_base_log_prob,
                                        make_system_target, sample_base)
from enflow_tpu_torch.train.driver import Main, vi_anneal
from enflow_tpu_torch.train.optim import NLLOptimizer
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten
from torch_threads import one_torch_thread  # noqa: F401

N, NF, H = 4, 3, 8


def _positions(P=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(P, N, 3)) * 0.9
    x[1, 2] = x[1, 0]                           # a coincident pair
    return x


@pytest.mark.parametrize("soft,cap", [(0.2, 100.0), (0.0, 500.0),
                                      (0.07, 3.4028234663852886e38)])
def test_lj_cluster_overrides_match_jax_f64(soft, cap):
    x = _positions()
    jt = j_targets.lj_cluster(N, kBT=2.0, c_osc=0.5, softening=0.0,
                              e_cap=500.0)
    tt = targets.lj_cluster(N, kBT=2.0, c_osc=0.5, softening=0.0,
                            e_cap=500.0)

    def jf(pos):
        return jt.log_prob(pos, softening=jnp.asarray(soft),
                           e_cap=jnp.asarray(cap))

    jv = jax.vmap(jf)(jnp.asarray(x))
    jg = jax.vmap(jax.grad(jf))(jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    tv = tt.log_prob(tx, softening=soft, e_cap=cap)
    (tg,) = torch.autograd.grad(tv.sum(), tx)
    assert np.isfinite(np.asarray(jv)).all()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jg)).max())


def test_lj_cluster_static_call_keeps_the_plain_branch():
    """Without overrides softening 0 is the plain LJ, whose coincident pair
    gives inf - inf (NaN), as the JAX package's static call; the override
    drops the pair."""
    x = torch.from_numpy(_positions())
    t = targets.lj_cluster(N, kBT=2.0, softening=0.0, e_cap=500.0)
    plain = t.log_prob(x)
    over = t.log_prob(x, softening=0.0, e_cap=500.0)
    assert torch.isnan(plain[1]) and torch.isfinite(over).all()
    np.testing.assert_allclose(plain[[0, 2, 3, 4]].numpy(),
                               over[[0, 2, 3, 4]].numpy(), rtol=1e-12)


def _vi_case(dtype, use_pallas, stl, n_atoms=N, P=6):
    """Loss and parameter gradients of both packages on one base batch of
    ``P`` particles of ``n_atoms`` atoms."""
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H, use_pallas=use_pallas), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, H, use_pallas=use_pallas), **kw)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jp = j_init_flow(jax.random.PRNGKey(0), jcfg, jdt)
    stds = dict(pos_std=0.8, vel_std=1.1, feat_std=0.9)
    n, rng = n_atoms, np.random.default_rng(1)
    draws = {"h": rng.normal(size=(P, n, NF)) * stds["feat_std"],
             "g": rng.normal(size=(P, n, NF)) * stds["feat_std"],
             "pos": rng.normal(size=(P, n, 3)) * stds["pos_std"],
             "vel": rng.normal(size=(P, n, 3)) * stds["vel_std"]}
    draws = {k: v.astype(dtype) for k, v in draws.items()}
    rest = dict(mask=np.ones((P, n), bool), box=np.full((P, 3), 1e3, dtype),
                r_cut=np.full((P,), 1e2, dtype))
    jbatch = JSystem(**{k: jnp.asarray(v) for k, v in {**draws,
                                                       **rest}.items()})
    tbatch = System(**{k: torch.from_numpy(v.copy())
                       for k, v in {**draws, **rest}.items()})
    soft, cap, beta = 0.1, 150.0, 0.8
    jt = j_targets.lj_cluster(n, kBT=2.0, c_osc=0.5, e_cap=500.0)
    jtgt = j_system_target(
        lambda x: jnp.asarray(beta, jdt) * jt.log_prob(
            x, softening=jnp.asarray(soft, jdt), e_cap=jnp.asarray(cap, jdt)),
        kBT_aux=1.3)
    tt = targets.lj_cluster(n, kBT=2.0, c_osc=0.5, e_cap=500.0)
    ttgt = make_system_target(
        lambda x: beta * tt.log_prob(x, softening=soft, e_cap=cap),
        kBT_aux=1.3)

    def jloss(p):
        return j_flow_vi_loss(p, jcfg, jbatch, jtgt, stl=stl,
                              base_log_prob=j_base_log_prob(**stds))[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    ops.counts.reset()
    tl, _ = flow_vi_loss(tp, tcfg, tbatch, ttgt, stl=stl,
                         base_log_prob=make_base_log_prob(**stds))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    # the dequantizer's parameters take no part: no gradient, JAX's zeros
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    return float(jl), float(tl.detach()), want, grads


@pytest.mark.parametrize("n_atoms,P", [(N, 6), (55, 2)])
@pytest.mark.parametrize("stl", [False, True])
def test_flow_vi_loss_matches_jax_f64(stl, n_atoms, P):
    """N=55 is vi_lj55.yaml's cluster (at a narrow width, 2 particles)."""
    jl, tl, want, grads = _vi_case(np.float64, False, stl, n_atoms, P)
    assert tl == pytest.approx(jl, rel=1e-9)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


def test_flow_vi_loss_matches_pallas_f32():
    jl, tl, want, grads = _vi_case(np.float32, "v3", False)
    # every EGCL of the reverse flow went through the kernel's plain
    # version, its backward with parameter gradients
    assert (ops.counts.plain_fwd_calls, ops.counts.plain_bwd_param_calls,
            ops.counts.plain_bwd_calls) == (2, 2, 0)
    assert tl == pytest.approx(jl, rel=2e-4)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * np.abs(w).max())


def test_sample_base_defaults_to_the_card():
    """Without ``device`` the base batch is drawn on ``cuda``; with no card
    that raises instead of falling back to the CPU. With ``device="cpu"``
    it matches the base density's shapes and draws from the generator."""
    kw = dict(box=1e3, r_cut=1e2)
    if torch.cuda.is_available():
        batch = sample_base(torch.Generator("cuda").manual_seed(0), 3, N, NF,
                            **kw)
        assert batch.pos.is_cuda and batch.h.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sample_base(torch.Generator().manual_seed(0), 3, N, NF, **kw)
    a = sample_base(torch.Generator().manual_seed(5), 3, N, NF, device="cpu",
                    **kw)
    b = sample_base(torch.Generator().manual_seed(5), 3, N, NF, device="cpu",
                    **kw)
    assert a.h.shape == (3, N, NF) and a.pos.shape == (3, N, 3)
    assert torch.equal(a.pos, b.pos) and not torch.equal(a.h, a.g)
    assert make_base_log_prob()(a).shape == (3,)


def test_vi_anneal_schedule_of_vi_lj13():
    root = pathlib.Path(__file__).resolve().parent.parent
    with open(root / "example" / "vi_lj13.yaml") as f:
        tgt = yaml.safe_load(f)["training"]["target"]
    sched = vi_anneal(tgt)
    # softening 0.2 -> 0 linearly, cap 1/cap from 1/100 to 1/500 linearly,
    # beta 1 throughout; flat after epoch 50
    for epoch, (s, c) in {0: (0.2, 100.0), 25: (0.1, 1.0 / 0.006),
                          50: (0.0, 500.0), 60: (0.0, 500.0)}.items():
        soft, cap, beta = sched(epoch)
        assert soft == pytest.approx(s, abs=1e-15)
        assert cap == pytest.approx(c, rel=1e-12)
        assert beta == 1.0
    assert vi_anneal({"type": "lj_cluster"}) is None
    uncapped = vi_anneal({"anneal": {"e_cap_start": 20.0, "epochs": 2}})
    assert uncapped(0)[1] == 20.0
    assert uncapped(2)[1] == float(np.finfo(np.float32).max)
    with pytest.raises(ValueError, match="beta_start"):
        vi_anneal({"anneal": {"beta_start": 0.0}})


def test_vi_anneal_schedule_of_vi_lj55():
    """vi_lj55.yaml keeps its energy cap at 2000 throughout (no
    e_cap_start) and anneals the softening 0.2 -> 0 over 25 epochs
    (enflow_tpu/train/driver.py:854-894)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    with open(root / "example" / "vi_lj55.yaml") as f:
        tgt = yaml.safe_load(f)["training"]["target"]
    sched = vi_anneal(tgt)
    for epoch, s in {0: 0.2, 5: 0.16, 12: 0.104, 25: 0.0, 39: 0.0}.items():
        soft, cap, beta = sched(epoch)
        assert soft == pytest.approx(s, abs=1e-15)
        assert cap == pytest.approx(2000.0, rel=1e-12)
        assert beta == 1.0


def test_vi_optimizer_chain_matches_optax():
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(3, 4)), "b": [rng.normal(size=(5,))]}
    lr, clip = 1e-2, 1.5
    nan_to_zero = optax.stateless(
        lambda u, params=None: jax.tree_util.tree_map(
            lambda g: jnp.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0), u))
    tx = optax.chain(nan_to_zero, optax.clip_by_global_norm(clip),
                     optax.adam(lr))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    tparams = from_jax_params(params, device="cpu")
    leaves, _ = tree_flatten(tparams)
    for t in leaves:
        t.requires_grad_(True)
    opt = NLLOptimizer(leaves, lr, grad_clip=clip, zero_nonfinite=True)
    for step in range(3):
        g = {"a": rng.normal(size=(3, 4)) * 3.0, "b": [rng.normal(size=(5,))]}
        if step == 0:
            g["a"][0, 0], g["b"][0][2] = np.nan, np.inf
        if step == 1:
            g["a"][2, 1] = -np.inf
        grads = jax.tree_util.tree_map(jnp.asarray, g)
        upd, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for t, gg in zip(leaves, jax.tree_util.tree_leaves(grads)):
            t.grad = torch.from_numpy(np.array(gg))
        opt.step()
    for want, got in zip(jax.tree_util.tree_leaves(jparams), leaves):
        assert np.isfinite(got.detach().numpy()).all()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-10)
    jstate = jax.tree_util.tree_leaves(state)
    tstate = opt.state_leaves()
    assert len(jstate) == len(tstate)
    for want, got in zip(jstate, tstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


# --- the driver -------------------------------------------------------------

def _vi_yaml(path, epochs, kernel="v3", cdt="bfloat16", stl=False):
    cfg = {
        "mode": "train", "units": {"time": "pico", "dist": "ang"},
        "precision": "float32", "seed": 4,
        "dynamics": {"integrator": "lf", "n_iter": 2, "dt": 1,
                     "checkpoint_path": str(path / "vi.cpt"),
                     "nbr_mode": "all_pairs", "compute_dtype": cdt,
                     "network": {"hidden_nf": H, "node_nf": NF,
                                 "use_pallas": kernel}},
        "training": {"objective": "flow_vi", "stl": stl,
                     "num_epochs": epochs, "steps_per_epoch": 3,
                     "n_particles": 8, "lr": 1e-3, "grad_clip": 5.0,
                     "scheduler": False, "log_interval": 1,
                     "metrics_csv": str(path / "metrics.csv"),
                     "target": {"type": "lj_cluster", "n_atoms": N,
                                "kBT": 2.0, "c_osc": 0.5, "softening": 0.0,
                                "e_cap": 500.0,
                                "anneal": {"softening_start": 0.2,
                                           "e_cap_start": 100.0,
                                           "epochs": 2}}},
    }
    out = path / "vi.yaml"
    out.write_text(yaml.safe_dump(cfg))
    return str(out)


def _rows(path):
    with open(path / "metrics.csv") as f:
        return list(csv.DictReader(f))


def test_vi_driver_trains_resumes_and_draws_as_uninterrupted(tmp_path,
                                                            capsys):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    ops.counts.reset()
    Main(device="cpu")(_vi_yaml(a, 2))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Epoch \tVI Loss \t   Time (s)"
    rows = [ln.split(" \t    ") for ln in out[1:]]
    assert [r[0] for r in rows] == ["00000", "00001"]
    assert all(np.isfinite(float(r[1])) and r[3] == "1.00e-03" for r in rows)
    # 2 epochs x 3 steps x 2 EGCLs through the kernel's plain version
    assert ops.counts.plain_bwd_param_calls == 12
    resumed = Main(device="cpu")
    resumed.setup(_vi_yaml(a, 1))
    assert resumed.start_epoch == 2 and resumed.optimizer.steps_taken == 6
    resumed.train()
    assert capsys.readouterr().out.splitlines()[-1].startswith("00002 \t")
    got = [r["epoch"] for r in _rows(a)]
    assert got == ["0", "1", "2"]
    assert set(_rows(a)[0]) == {"time", "epoch", "loss", "epoch_seconds",
                                "lr", "batches"}
    assert all(r["batches"] == "3" for r in _rows(a))

    whole = Main(device="cpu")
    whole.setup(_vi_yaml(b, 3))
    whole.train()
    for x, y in zip(resumed._leaves, whole._leaves):
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy())
    assert [r["loss"] for r in _rows(a)] == [r["loss"] for r in _rows(b)]


def test_vi_checkpoints_cross_packages(tmp_path, capsys):
    """The port resumes a VI checkpoint of the JAX driver (parameters and
    the optimizer chain's state), and the JAX driver resumes the port's."""
    cfg = _vi_yaml(tmp_path, 1, kernel=False, cdt=None)
    jm = JMain()
    jm(cfg)
    tm = Main(device="cpu")
    tm.setup(cfg)
    assert tm.start_epoch == 1 and tm.optimizer.steps_taken == 3
    for want, got in zip(jax.tree_util.tree_leaves(jm.params), tm._leaves):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for want, got in zip(jax.tree_util.tree_leaves(jm.opt_state),
                         tm.optimizer.state_leaves()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tm.train()
    back = JMain()
    back.setup(cfg)
    assert back.start_epoch == 2
    for want, got in zip(tm._leaves, jax.tree_util.tree_leaves(back.params)):
        np.testing.assert_array_equal(np.asarray(got),
                                      want.detach().numpy())
    assert int(jax.tree_util.tree_leaves(back.opt_state)[0]) == 6
    capsys.readouterr()
