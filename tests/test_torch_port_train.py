"""Port parity: NLL training.

- One NLL step at float64 on a padded images-mode batch (a padded atom, an
  all-masked dummy molecule, several periodic images per pair): the port's
  dequantizing ``forward`` with ``track_overflow`` and ``alchemical_nll``
  against ``jax.value_and_grad`` of the JAX driver's ``nll_fn``, with the
  parameters carried across by ``from_jax_params`` and JAX's dequantizer
  noise fed to the port. Loss and every parameter gradient within 1e-9
  relative (float64 round-off through two flow steps and the NLL).
- Three optimizer steps against ``optax.adam``, then with
  ``clip_by_global_norm``: parameters within 1e-10 and the state in optax's
  leaf order; and with a staircase schedule (2e-9: optax evaluates the
  schedule in float32).
- Checkpoints both ways, the driver end to end on the CPU with resume, and
  its metrics CSV.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow.integrators import FlowConfig as JFlowConfig
from enflow_tpu.flow.integrators import forward as j_forward
from enflow_tpu.flow.integrators import init_flow as j_init_flow
from enflow_tpu.flow.loss import alchemical_nll as j_nll
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from enflow_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig, forward, reverse
from enflow_tpu_torch.flow.loss import alchemical_nll
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.train.checkpoint import save_checkpoint
from enflow_tpu_torch.train.driver import Main
from enflow_tpu_torch.train.optim import NLLOptimizer
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten

B, N, NF, H = 4, 5, 2, 16
KBT, SOFT = 1.3, 0.1


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), bool)
    mask[1, -1] = False
    mask[3] = False                                  # dummy molecule
    h = np.eye(NF)[rng.integers(0, NF, size=(B, N))] * mask[..., None]
    f = lambda *s: rng.normal(size=s) * mask[..., None]
    pos = rng.uniform(-1.6, 1.6, size=(B, N, 3)) * mask[..., None]
    box = np.full((B, 3), 3.2)
    r_cut = np.full((B,), 2.5)
    return dict(h=h, g=f(B, N, NF), pos=pos, vel=f(B, N, 3), mask=mask,
                box=box, r_cut=r_cut)


def _cfgs(cap):
    kw = dict(n_iter=2, dt=0.1, nbr_mode="images", nbr_capacity=cap,
              track_overflow=True)
    return (JFlowConfig(egcl=JEGCLConfig(NF, H), **kw),
            FlowConfig(egcl=EGCLConfig(NF, H), **kw))


def test_nll_step_matches_jax_f64():
    d = _batch()
    jcfg, tcfg = _cfgs(40)
    jp = j_init_flow(jax.random.PRNGKey(1), jcfg, jnp.float64)
    jb = JSystem(**{k: jnp.asarray(v) for k, v in d.items()})
    key = jax.random.PRNGKey(7)

    def nll_fn(p):
        out, ldj, ovf = j_forward(p, jcfg, jb, key)
        return j_nll(out, ldj, KBT, SOFT, num_log_gaussian_calls=3), ovf

    (jloss, jovf), jgrads = jax.value_and_grad(nll_fn, has_aux=True)(jp)
    eps = np.array(jax.random.normal(key, d["h"].shape, jnp.float64))

    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = System(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})
    out, ldj, ovf = forward(tp, tcfg, tb, eps=torch.from_numpy(eps))
    loss = alchemical_nll(out, ldj, KBT, SOFT, num_log_gaussian_calls=3)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-9)
    assert int(ovf) == int(jovf) == 0
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for want, got in zip(jl, grads):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    # the flow inverts back to the one-hot features and positions
    with torch.no_grad():
        back, _ = reverse(tp, tcfg, out)
    np.testing.assert_array_equal(back.h.numpy(), d["h"])
    np.testing.assert_allclose(back.pos.numpy(), d["pos"], atol=1e-10)


@pytest.mark.parametrize("clip,schedule,atol", [
    (None, None, 1e-10), (0.5, None, 1e-10),
    # optax evaluates the schedule in float32: its rate is off by ~3e-8
    (None, (2, 0.5), 2e-9)])
def test_optimizer_matches_optax(clip, schedule, atol):
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(3, 4)), "b": [rng.normal(size=(5,))]}
    lr = 1e-2
    lr_fn = (optax.exponential_decay(lr, schedule[0], schedule[1],
                                     staircase=True) if schedule else lr)
    steps = [optax.clip_by_global_norm(clip)] if clip else []
    tx = optax.chain(*steps, optax.adam(lr_fn))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)
    tparams = from_jax_params(params, device="cpu")
    leaves, _ = tree_flatten(tparams)
    for t in leaves:
        t.requires_grad_(True)
    opt = NLLOptimizer(leaves, lr, schedule=schedule, grad_clip=clip)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape) * 3.0), jparams)
        upd, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for t, g in zip(leaves, jax.tree_util.tree_leaves(grads)):
            t.grad = torch.from_numpy(np.array(g))
        opt.step()
    for want, got in zip(jax.tree_util.tree_leaves(jparams), leaves):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=atol)
    jstate = jax.tree_util.tree_leaves(state)
    tstate = opt.state_leaves()
    assert len(jstate) == len(tstate)
    for want, got in zip(jstate, tstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


# --- checkpoints and the driver --------------------------------------------

YAML = """\
mode: train
units: {{time: pico, dist: ang}}
precision: float32
seed: 2
dataset:
  type: lj
  n_atoms: 6
  box: [10.0, 10.0, 10.0]
  temp: 120
  n_iter: 160
  interval: 20
  discard: 40
  dt: 0.004
  friction: 1
  softening: 0.1
  gap: 2
  r_cut: 6.0
  minimize_steps: 50
  processed_file: {processed}
dynamics:
  integrator: lf
  n_iter: 2
  dt: 1
  checkpoint_path: {ckpt}
  nbr_mode: images
  nbr_capacity: auto
  network: {{hidden_nf: 16, use_pallas: {kernel}}}
training:
  num_epochs: {epochs}
  batch_size: 4
  lr: 1e-3
  scheduler: No
  loss: {{temp: 120, softening: 0.1}}
  log_interval: 1
"""


def _yaml(tmp_path, epochs, kernel="false"):
    cfg = tmp_path / "train.yaml"
    cfg.write_text(YAML.format(processed=tmp_path / "data" / "processed.pkl",
                               ckpt=tmp_path / "model.cpt", epochs=epochs,
                               kernel=kernel))
    return str(cfg)


def test_driver_trains_and_resumes_cpu(tmp_path, capsys):
    # a pickle at processed_file is never opened: the port keeps its own npz
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "processed.pkl").write_bytes(b"not a pickle")
    cfg = _yaml(tmp_path, 2, kernel="v1")
    Main(device="cpu")(cfg)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Epoch \tTraining Loss \t   Time (s)"
    rows = [ln.split(" \t    ") for ln in out[1:]]
    assert [r[0] for r in rows] == ["00000", "00001"]
    assert all(np.isfinite(float(r[1])) and r[3] == "1.00e-03" for r in rows)
    assert (tmp_path / "data" / "processed.torch.npz").exists()
    assert (tmp_path / "model.cpt").exists()
    main = Main(device="cpu")
    main.setup(cfg)
    assert main.start_epoch == 2
    assert main.optimizer.steps_taken == 2 * 2           # 7 frames / batch 4
    main.train()
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("00003 \t")


def test_driver_writes_nll_metrics_csv(tmp_path):
    """``training.metrics_csv`` for the NLL objective: one row per epoch
    with the JAX driver's columns."""
    cfg = tmp_path / "m.yaml"
    cfg.write_text(open(_yaml(tmp_path, 2)).read().replace(
        "log_interval: 1", f"log_interval: 1\n  metrics_csv: "
        f"{tmp_path / 'm.csv'}"))
    Main(device="cpu")(str(cfg))
    with open(tmp_path / "m.csv") as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "time,epoch,loss,epoch_seconds,lr,batches,nbr_overflow"
    rows = [ln.split(",") for ln in lines[1:]]
    assert [r[1] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(r[2])) and r[5] == "2"
               and int(r[6]) >= 0 for r in rows)


def test_checkpoints_cross_packages(tmp_path):
    """A port checkpoint loads in the JAX package, and the port resumes a
    checkpoint the JAX package wrote (params and Adam state)."""
    cfg = _yaml(tmp_path, 1)
    Main(device="cpu")(cfg)
    ckpt = str(tmp_path / "model.cpt")
    jcfg = JFlowConfig(n_iter=2, dt=1.0, egcl=JEGCLConfig(1, 16),
                       nbr_mode="images")
    jparams = j_init_flow(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tx = optax.adam(1e-3)
    trees, hp = j_load_checkpoint(ckpt, {"params": jparams,
                                         "opt_state": tx.init(jparams)})
    main = Main(device="cpu")
    main.setup(cfg)
    for want, got in zip(jax.tree_util.tree_leaves(trees["params"]),
                         main._leaves):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert int(trees["opt_state"][0].count) == 2

    # the JAX package writes a checkpoint at epoch 6 after three updates
    p = trees["params"]
    st = tx.init(p)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.3), p)
        u, st = tx.update(g, st, p)
        p = optax.apply_updates(p, u)
    hp = dict(hp, epoch=6)
    j_save_checkpoint(ckpt, {"params": p, "opt_state": st}, hp)
    main = Main(device="cpu")
    main.setup(cfg)
    assert main.start_epoch == 7 and main.optimizer.steps_taken == 3
    adam = main.optimizer.adam
    mu = jax.tree_util.tree_leaves(st[0].mu)
    nu = jax.tree_util.tree_leaves(st[0].nu)
    for t, m, v, w in zip(main._leaves, mu, nu, jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(adam.state[t]["exp_avg"].numpy(),
                                      np.asarray(m))
        np.testing.assert_array_equal(adam.state[t]["exp_avg_sq"].numpy(),
                                      np.asarray(v))
        assert float(adam.state[t]["step"]) == 3.0
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(w))
    with np.load(ckpt) as z:
        assert json.loads(bytes(z["hparams"]).decode())["epoch"] == 6
    # and the port's own writer gives the JAX package the same leaves back
    save_checkpoint(ckpt, {"params": main.params,
                           "opt_state": main.optimizer.state_leaves()}, hp)
    back, _ = j_load_checkpoint(ckpt, {"params": jparams,
                                       "opt_state": tx.init(jparams)})
    for want, got in zip(jax.tree_util.tree_leaves(st),
                         jax.tree_util.tree_leaves(back["opt_state"])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_driver_rejects_unported_train_options(tmp_path):
    """Atom sharding over more devices than there are is refused as in
    JAX (ROADMAP A7 is ported); the options that waited on A5.6 and A6 now
    set up: the profiler directory, the NaN guard and a ``compose``
    dataset; a reader without its files fails as in JAX."""
    cfg = tmp_path / "t.yaml"
    base = _yaml(tmp_path, 1)
    text = open(base).read()
    cfg.write_text(text.replace("seed: 2",
                                "seed: 2\nparallel: {atom_axis: 4}"))
    with pytest.raises(ValueError, match="must divide the device count"):
        Main(device="cpu").setup(str(cfg))
    # a reader type without its required files (JAX: the same TypeError)
    cfg.write_text(text.replace("type: lj", "type: md"))
    with pytest.raises(TypeError, match="top_file"):
        Main(device="cpu").setup(str(cfg))
    cfg.write_text(text.replace(
        "log_interval: 1", "log_interval: 1\n  profile_dir: prof").replace(
        "seed: 2", "seed: 2\ndebug: {nan_checks: true}"))
    main = Main(device="cpu")
    main.setup(str(cfg))
    assert main.profile_dir == "prof" and main.nan_checks
    # compose of one part: the lj section under dataset1
    lj = text[text.index("dataset:\n"):text.index("dynamics:")]
    composed = text.replace(lj, "dataset: {type: compose, number: 1}\n"
                            + lj.replace("dataset:", "dataset1:"))
    cfg.write_text(composed)
    main = Main(device="cpu")
    main.setup(str(cfg))
    assert type(main.dataset).__name__ == "ComposeDatasets"
    assert len(main.dataset) == 7 and main.node_nf == 1