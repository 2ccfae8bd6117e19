"""Port parity: the learned position updates ('coupled', 'drift'), the VV
integrator and the Floor dequantizer.

Parameters go from the JAX package to the port with ``from_jax_params``;
the zero-initialized drift heads are perturbed first so that ``S`` and
``Fp`` are not 0. The same numpy state (and, for Floor, the JAX package's
uniform draw) goes through both packages; outputs and ldj agree at float64
to 1e-10, as in ``test_torch_port_flow.py``. The behaviour cases follow
``tests/test_position_coupling.py`` on the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import forward as j_forward
from enflow_tpu.flow import forward_core as j_forward_core
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.flow import reverse as j_reverse
from enflow_tpu.flow import reverse_core as j_reverse_core
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.train import checkpoint as jckpt

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import (FlowConfig, forward, forward_core,
                                   init_flow, reverse, reverse_core)
from enflow_tpu_torch.flow.integrators import _lf_forward
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import egcl_allpairs as ea
from enflow_tpu_torch.train import checkpoint as tckpt
from enflow_tpu_torch.utils.helpers import min_image
from enflow_tpu_torch.utils.jax_params import (from_jax_params, tree_flatten,
                                               tree_unflatten)
from torch_threads import one_torch_thread  # noqa: F401

B, N, NF, H = 2, 5, 4, 16
F64 = torch.float64


def _state(seed=0, box_len=1e6, nf=NF, n=N, pad=True, one_hot=False):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, n), bool)
    if pad:
        mask[1, -1] = False
    h = (np.eye(nf)[rng.integers(0, nf, size=(B, n))] if one_hot
         else rng.normal(size=(B, n, nf)) * 0.5)
    if box_len < 100:
        pos = rng.uniform(-box_len / 2, box_len / 2, size=(B, n, 3))
    else:
        pos = rng.normal(size=(B, n, 3))
    arrs = {"h": h, "g": rng.normal(size=(B, n, nf)) * 0.3, "pos": pos,
            "vel": rng.normal(size=(B, n, 3)) * 0.5}
    for a in arrs.values():
        a[~mask] = 0.0
    box = np.full((B, 3), box_len)
    r_cut = np.full((B,), 1e5)
    jsys = JSystem(mask=jnp.asarray(mask), box=jnp.asarray(box),
                   r_cut=jnp.asarray(r_cut),
                   **{k: jnp.asarray(v) for k, v in arrs.items()})
    tsys = System(mask=torch.from_numpy(mask), box=torch.from_numpy(box),
                  r_cut=torch.from_numpy(r_cut),
                  **{k: torch.from_numpy(v.copy()) for k, v in arrs.items()})
    return jsys, tsys


def _cfgs(**kw):
    base = dict(n_iter=3, dt=0.05, nbr_mode="all_pairs", exact_ldj=True)
    base.update(kw)
    return (JFlowConfig(egcl=JEGCLConfig(NF, H), **base),
            FlowConfig(egcl=EGCLConfig(NF, H), **base))


def _activate(jp, seed, scale=0.3):
    """Perturb the drift EGCLs (their S and Fp heads start at 0)."""
    leaves, tree = jax.tree_util.tree_flatten(jp["pos_networks"])
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + scale * rng.normal(size=x.shape)
              for x in leaves]
    return {**jp, "pos_networks": jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(x) for x in leaves])}


def _params(jcfg, seed):
    jp = j_init_flow(jax.random.PRNGKey(seed), jcfg, jnp.float64)
    if "pos_networks" in jp:
        jp = _activate(jp, seed + 100)
    return jp, from_jax_params(jp, device="cpu")


def _close(tsys, jsys, atol=1e-10, box=None):
    for f in ("h", "g", "pos", "vel"):
        got = getattr(tsys, f).numpy()
        want = np.asarray(getattr(jsys, f))
        if f == "pos" and box is not None:       # compare modulo the box
            got = want + np.asarray(min_image(torch.from_numpy(got - want),
                                              torch.tensor(box)))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=atol)


def _parity(jp, tp, jcfg, tcfg, jsys, tsys):
    jout, jldj = j_forward_core(jp, jcfg, jsys)
    tout, tldj = forward_core(tp, tcfg, tsys)
    _close(tout, jout)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10,
                               atol=1e-10)
    jback, jldj_r = j_reverse_core(jp, jcfg, jsys)
    tback, tldj_r = reverse_core(tp, tcfg, tsys)
    _close(tback, jback)
    np.testing.assert_allclose(tldj_r.numpy(), np.asarray(jldj_r),
                               rtol=1e-10, atol=1e-10)
    return tout, tldj


@pytest.mark.parametrize("update,exact_ldj,box", [
    ("coupled", True, 1e6), ("coupled", False, 1e6),
    ("drift", True, 1e6), ("drift", False, 3.5)],
    ids=["coupled-exact", "coupled-parity", "drift-exact",
         "drift-parity-box3.5"])
def test_learned_drift_matches_jax_f64(update, exact_ldj, box):
    jcfg, tcfg = _cfgs(position_update=update, exact_ldj=exact_ldj)
    jp, tp = _params(jcfg, 1)
    jsys, tsys = _state(seed=2, box_len=box)
    tout, tldj = _parity(jp, tp, jcfg, tcfg, jsys, tsys)
    # the drift moves positions away from the shift flow's
    shift = dataclasses.replace(tcfg, position_update="shift")
    sout, _ = forward_core({k: v for k, v in tp.items()
                            if k != "pos_networks"}, shift, tsys)
    assert not torch.allclose(tout.pos, sout.pos, atol=1e-3)
    back, ldj_r = reverse_core(tp, tcfg, tout)
    _close(back, tsys, atol=1e-9, box=box if box < 100 else None)
    np.testing.assert_allclose(ldj_r.numpy(), -tldj.numpy(), atol=1e-9)


def test_fresh_coupled_flow_is_the_shift_flow():
    """Zeroed S and Fp heads: a fresh coupled flow gives the shift flow's
    outputs bit for bit, and the shift parameters are drawn first from the
    same generator."""
    _, tcfg = _cfgs(position_update="coupled")
    shift = dataclasses.replace(tcfg, position_update="shift")
    pc = init_flow(torch.Generator().manual_seed(3), tcfg, F64, "cpu")
    ps = init_flow(torch.Generator().manual_seed(3), shift, F64, "cpu")
    for a, b in zip(tree_flatten(ps)[0],
                    tree_flatten({k: pc[k] for k in ps})[0]):
        assert torch.equal(a, b)
    for head in ("vel_scaling_nn", "coord_nn"):
        assert all(float(x.abs().max()) == 0.0
                   for x in tree_flatten(pc["pos_networks"][head][-1])[0])
    _, tsys = _state(seed=4)
    oc, lc = forward_core(pc, tcfg, tsys)
    os_, ls = forward_core(ps, shift, tsys)
    for f in ("h", "g", "pos", "vel"):
        assert torch.equal(getattr(oc, f), getattr(os_, f))
    assert torch.equal(lc, ls)


def test_drift_ldj_is_zero():
    """With the kick EGCLs zeroed the drift flow adds no log-det, while its
    positions still move away from the shift flow's."""
    jcfg, tcfg = _cfgs(position_update="drift", exact_ldj=False)
    jp = j_init_flow(jax.random.PRNGKey(5), jcfg, jnp.float64)
    jp["networks"] = jax.tree_util.tree_map(jnp.zeros_like, jp["networks"])
    tp = from_jax_params(_activate(jp, 6, scale=1.0), device="cpu")
    _, tsys = _state(seed=6)
    out, ldj, _ = _lf_forward(tp, tcfg, tsys)
    assert torch.equal(ldj, torch.zeros_like(ldj))
    shift = dataclasses.replace(tcfg, position_update="shift")
    out_s, _, _ = _lf_forward({k: v for k, v in tp.items()
                               if k != "pos_networks"}, shift, tsys)
    assert not torch.allclose(out.pos, out_s.pos, atol=1e-3)


def test_coupled_ldj_factor_is_exact_in_parity_mode():
    """The drift's S term uses the factor 3 also when ``exact_ldj`` is off:
    with the kicks zeroed, parity and exact modes give the same ldj."""
    jcfg, tcfg = _cfgs(position_update="coupled")
    jp = j_init_flow(jax.random.PRNGKey(7), jcfg, jnp.float64)
    jp["networks"] = jax.tree_util.tree_map(jnp.zeros_like, jp["networks"])
    tp = from_jax_params(_activate(jp, 7), device="cpu")
    _, tsys = _state(seed=8)
    _, l_exact, _ = _lf_forward(tp, tcfg, tsys)
    _, l_parity, _ = _lf_forward(
        tp, dataclasses.replace(tcfg, exact_ldj=False), tsys)
    assert float(l_exact.abs().max()) > 0.0
    torch.testing.assert_close(l_parity, l_exact, rtol=1e-12, atol=0)


@pytest.mark.parametrize("update", ["coupled", "drift"])
def test_learned_drift_ldj_matches_autodiff(update):
    nf = 2
    cfg = FlowConfig(n_iter=2, dt=0.05, nbr_mode="all_pairs", exact_ldj=True,
                     egcl=EGCLConfig(nf, 8), position_update=update)
    jcfg = JFlowConfig(n_iter=2, dt=0.05, nbr_mode="all_pairs",
                       exact_ldj=True, egcl=JEGCLConfig(nf, 8),
                       position_update=update)
    jp = j_init_flow(jax.random.PRNGKey(9), jcfg, jnp.float64)
    tp = from_jax_params(_activate(jp, 10), device="cpu")
    n = 3
    sizes = [n * nf, n * nf, n * 3, n * 3]
    one = lambda v: torch.full((1,) + v[0], v[1], dtype=F64)

    def run(x):
        hs, gs, ps, vs = torch.split(x, sizes)
        s = System(h=hs.reshape(1, n, nf), g=gs.reshape(1, n, nf),
                   pos=ps.reshape(1, n, 3), vel=vs.reshape(1, n, 3),
                   mask=torch.ones((1, n), dtype=torch.bool),
                   box=one(((3,), 1e6)), r_cut=one(((), 1e5)))
        out, ldj, _ = _lf_forward(tp, cfg, s)
        return torch.cat([out.h.ravel(), out.g.ravel(), out.pos.ravel(),
                          out.vel.ravel()]), ldj

    x0 = torch.from_numpy(np.random.default_rng(11).normal(size=sum(sizes)))
    J = torch.autograd.functional.jacobian(lambda x: run(x)[0], x0)
    sign, logdet = torch.linalg.slogdet(J)
    assert float(sign) > 0
    assert float(run(x0)[1][0]) == pytest.approx(float(logdet), abs=1e-8)


def test_coupled_rotation_equivariance():
    jcfg, tcfg = _cfgs(position_update="coupled")
    _, tp = _params(jcfg, 12)
    _, tsys = _state(seed=13, pad=False)
    A = np.random.default_rng(14).normal(size=(3, 3))
    rot, _ = np.linalg.qr(A)
    rot = torch.from_numpy(rot)
    out, ldj = forward_core(tp, tcfg, tsys)
    out_r, ldj_r = forward_core(tp, tcfg, tsys.replace(
        pos=tsys.pos @ rot.T, vel=tsys.vel @ rot.T))
    torch.testing.assert_close(out_r.pos, out.pos @ rot.T, rtol=0,
                               atol=1e-8)
    torch.testing.assert_close(out_r.vel, out.vel @ rot.T, rtol=0,
                               atol=1e-8)
    torch.testing.assert_close(ldj_r, ldj, rtol=0, atol=1e-8)


def test_coupled_gradient_reaches_the_drift_networks():
    """The zeroed heads still receive gradients: the coupling trains from
    its first step."""
    from enflow_tpu_torch.sample.vi import (flow_vi_loss, make_system_target,
                                            sample_base)
    _, tcfg = _cfgs(position_update="coupled", n_iter=2)
    tp = init_flow(torch.Generator().manual_seed(15), tcfg, F64, "cpu")
    leaves, struct = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    batch = sample_base(torch.Generator().manual_seed(16), 4, 6, NF,
                        box=1e6, r_cut=1e5, dtype=F64, device="cpu")
    target = make_system_target(lambda x: -2.0 * (x ** 2).sum(dim=(1, 2)))
    loss, _ = flow_vi_loss(tree_unflatten(struct, leaves), tcfg, batch,
                           target)
    loss.backward()
    pos_leaves, _ = tree_flatten(tp["pos_networks"])
    g = sum(float(t.grad.abs().sum()) for t in pos_leaves
            if t.grad is not None)
    assert np.isfinite(g) and g > 0.0


def test_learned_drift_guards():
    _, tcfg = _cfgs(position_update="coupled")
    gen = torch.Generator().manual_seed(0)
    for mode in ("images", "cell"):
        with pytest.raises(ValueError, match="periodic"):
            init_flow(gen, dataclasses.replace(tcfg, nbr_mode=mode,
                                               nbr_capacity=8), F64, "cpu")
    with pytest.warns(UserWarning, match="open"):
        init_flow(gen, dataclasses.replace(tcfg, nbr_mode="dense"), F64,
                  "cpu")
    for update in ("coupled", "drift"):
        with pytest.raises(ValueError, match="leapfrog"):
            init_flow(gen, dataclasses.replace(
                tcfg, position_update=update, integrator="vv"), F64, "cpu")
    # 'drift' is the periodic-box variant: no guard
    init_flow(gen, dataclasses.replace(tcfg, position_update="drift",
                                       nbr_mode="images", nbr_capacity=8),
              F64, "cpu")


def test_drift_egcl_is_one_more_kernel_call_per_step():
    """Through the kernel's contract (``use_pallas: v3``, its plain version
    on the CPU) a drift flow step is two fused EGCLs: the kick and the
    drift."""
    kw = dict(n_iter=3, dt=0.05, nbr_mode="all_pairs", exact_ldj=True,
              position_update="drift")
    cfg = FlowConfig(egcl=EGCLConfig(NF, H, use_pallas="v3"), **kw)
    tp = init_flow(torch.Generator().manual_seed(17), cfg, torch.float32,
                   "cpu")
    _, tsys = _state(seed=18, box_len=3.5)
    tsys = tsys.astype(torch.float32)
    ea.counts.reset()
    with torch.no_grad():
        out, _ = forward_core(tp, cfg, tsys)
        back, _ = reverse_core(tp, cfg, out)
    assert ea.counts.plain_fwd_calls == 2 * 2 * cfg.n_iter
    assert ea.counts.fwd_launches == 0
    dpos = min_image(back.pos - tsys.pos, tsys.box[:, None])
    assert float(dpos.abs().max()) < 1e-4


@pytest.mark.parametrize("exact_ldj", [False, True])
def test_vv_matches_jax_f64(exact_ldj):
    jcfg, tcfg = _cfgs(integrator="vv", exact_ldj=exact_ldj)
    jp, tp = _params(jcfg, 19)
    assert len(tp["networks"]["edge_nn"][0]["w"]) == tcfg.n_iter + 1
    jsys, tsys = _state(seed=20)
    tout, tldj = _parity(jp, tp, jcfg, tcfg, jsys, tsys)
    back, ldj_r = reverse_core(tp, tcfg, tout)
    _close(back, tsys, atol=1e-9)
    np.testing.assert_allclose(ldj_r.numpy(), -tldj.numpy(), atol=1e-9)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_floor_dequantizer_matches_jax(scale):
    jcfg, tcfg = _cfgs(dequantizer="floor", dequant_scale=scale,
                       exact_ldj=False)
    jp, tp = _params(jcfg, 21)
    assert tp["dequant"] == {}
    jsys, tsys = _state(seed=22, one_hot=True)
    key = jax.random.PRNGKey(23)
    noise = np.array(jax.random.uniform(key, tsys.h.shape, jnp.float64))
    jout, jldj = j_forward(jp, jcfg, jsys, key)
    tout, tldj = forward(tp, tcfg, tsys, eps=torch.from_numpy(noise))
    _close(tout, jout)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10,
                               atol=1e-10)
    jback = j_reverse(jp, jcfg, jout)
    tback = reverse(tp, tcfg, tout)
    _close(tback, jback, atol=1e-9)
    np.testing.assert_array_equal(tback.h.numpy(), tsys.h.numpy())
    # drawn from a generator: U[0, scale) added on real atoms only
    z, _ = forward(tp, tcfg, tsys, gen=torch.Generator().manual_seed(0))
    back = reverse(tp, tcfg, z)
    np.testing.assert_array_equal(back.h.numpy(), tsys.h.numpy())


def test_coupled_forward_reverse_with_argmax():
    jcfg, tcfg = _cfgs(position_update="coupled", dequantizer="argmax")
    _, tp = _params(jcfg, 24)
    _, tsys = _state(seed=25, one_hot=True)
    out, ldj = forward(tp, tcfg, tsys, gen=torch.Generator().manual_seed(1))
    assert torch.isfinite(ldj).all()
    back = reverse(tp, tcfg, out)
    torch.testing.assert_close(back.pos, tsys.pos, rtol=0, atol=1e-8)
    torch.testing.assert_close(back.vel, tsys.vel, rtol=0, atol=1e-8)
    assert torch.equal(back.h, tsys.h)


def test_coupled_checkpoint_crosses_packages(tmp_path):
    """A coupled flow's ``pos_networks`` travel both ways: JAX writes and
    the port reads, the port writes and JAX reads."""
    jcfg, tcfg = _cfgs(position_update="coupled")
    jp, _ = _params(jcfg, 26)
    jsys, tsys = _state(seed=27)
    path = str(tmp_path / "j.cpt")
    jckpt.save_checkpoint(path, {"params": jp}, {"epoch": 0})
    template = init_flow(torch.Generator().manual_seed(0), tcfg, F64, "cpu")
    tree, _ = tckpt.load_checkpoint(path, {"params": template})
    jout, jldj = j_forward_core(jp, jcfg, jsys)
    tout, tldj = forward_core(tree["params"], tcfg, tsys)
    _close(tout, jout)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10)

    # the port's own flow, written by the port and read by JAX
    tp = init_flow(torch.Generator().manual_seed(28), tcfg, F64, "cpu")
    leaves, struct = tree_flatten(tp)
    rng = np.random.default_rng(29)
    tp = tree_unflatten(struct, [t + 0.1 * torch.from_numpy(
        rng.normal(size=tuple(t.shape))) for t in leaves])
    path2 = str(tmp_path / "t.cpt")
    tckpt.save_checkpoint(path2, {"params": tp}, {"epoch": 0})
    jtemplate = j_init_flow(jax.random.PRNGKey(0), jcfg, jnp.float64)
    jtree, _ = jckpt.load_checkpoint(path2, {"params": jtemplate})
    jout, jldj = j_forward_core(jtree["params"], jcfg, jsys)
    tout, tldj = forward_core(tp, tcfg, tsys)
    _close(tout, jout)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10)
