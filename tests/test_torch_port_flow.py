"""Port parity: the leapfrog flow and the checkpoint bridge.

The same numpy state goes through ``enflow_tpu.flow`` and the port's
``forward_core``/``reverse_core`` with parameters carried across by
``from_jax_params`` or a checkpoint written by the JAX package.
Tolerances: float64 round-off (1e-10) for the plain path; the f32 case on
the kernel's plain version uses ``tests/test_egcl_fused.py``'s flow
tolerance.
"""

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
from enflow_tpu.train.checkpoint import save_checkpoint

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import (FlowConfig, forward_core, init_flow,
                                   reverse_core)
from enflow_tpu_torch.nn.argmax import init_argmax
from enflow_tpu_torch.nn.egcl import EGCLConfig, init_egcl
from enflow_tpu_torch.nn.mlp import init_mlp
from enflow_tpu_torch.train.checkpoint import load_checkpoint
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten

B, N, NF, H = 3, 5, 5, 16


def _state(seed=0, dtype=np.float64, box_len=1e3):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), bool)
    mask[1, -1] = False
    arrs = {"h": rng.normal(size=(B, N, NF)), "g": rng.normal(size=(B, N, NF)),
            "pos": rng.normal(size=(B, N, 3)),
            "vel": rng.normal(size=(B, N, 3))}
    for a in arrs.values():
        a[~mask] = 0.0
    arrs = {k: v.astype(dtype) for k, v in arrs.items()}
    box = np.full((B, 3), box_len, dtype)
    r_cut = np.full((B,), 1e2, dtype)
    jsys = JSystem(mask=jnp.asarray(mask), box=jnp.asarray(box),
                   r_cut=jnp.asarray(r_cut),
                   **{k: jnp.asarray(v) for k, v in arrs.items()})
    tsys = System(mask=torch.from_numpy(mask), box=torch.from_numpy(box),
                  r_cut=torch.from_numpy(r_cut),
                  **{k: torch.from_numpy(v.copy()) for k, v in arrs.items()})
    return jsys, tsys


def _cfgs(exact_ldj, use_pallas=False):
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs", exact_ldj=exact_ldj)
    return (JFlowConfig(egcl=JEGCLConfig(NF, H, use_pallas=use_pallas), **kw),
            FlowConfig(egcl=EGCLConfig(NF, H, use_pallas=use_pallas), **kw))


def _close(tsys, jsys, rtol, atol):
    for f in ("h", "g", "pos", "vel"):
        np.testing.assert_allclose(getattr(tsys, f).numpy(),
                                   np.asarray(getattr(jsys, f)),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("exact_ldj", [False, True])
def test_flow_matches_jax_f64(exact_ldj):
    jcfg, tcfg = _cfgs(exact_ldj)
    jp = j_init_flow(jax.random.PRNGKey(0), jcfg, jnp.float64)
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _state()
    jout, jldj = j_forward_core(jp, jcfg, jsys)
    tout, tldj = forward_core(tp, tcfg, tsys)
    _close(tout, jout, 1e-10, 1e-10)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10,
                               atol=1e-10)
    jback, jldj_r = j_reverse_core(jp, jcfg, jsys)
    tback, tldj_r = reverse_core(tp, tcfg, tsys)
    _close(tback, jback, 1e-10, 1e-10)
    np.testing.assert_allclose(tldj_r.numpy(), np.asarray(jldj_r),
                               rtol=1e-10, atol=1e-10)
    # round trip of the port alone
    back, ldj_r = reverse_core(tp, tcfg, tout)
    _close(back, tsys, 1e-10, 1e-10)
    np.testing.assert_allclose(ldj_r.numpy(), -tldj.numpy(), atol=1e-10)


def test_flow_kernel_contract_matches_jax_v3_f32():
    """``use_pallas: v3`` on the CPU: the port runs the kernel's plain
    version, JAX the Pallas kernel in interpret mode."""
    jcfg, tcfg = _cfgs(True, use_pallas="v3")
    jp = j_init_flow(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = from_jax_params(jp, device="cpu")
    jsys, tsys = _state(seed=2, dtype=np.float32)
    jout, jldj = j_forward_core(jp, jcfg, jsys)
    tout, tldj = forward_core(tp, tcfg, tsys)
    _close(tout, jout, 1e-4, 1e-5)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-4,
                               atol=1e-5)
    back, _ = reverse_core(tp, tcfg, tout)
    _close(back, tsys, 1e-4, 1e-5)


def test_unported_options_raise():
    _, tcfg = _cfgs(False)
    tp = init_flow(torch.Generator().manual_seed(0), tcfg, torch.float64,
                   "cpu")
    _, tsys = _state()
    import dataclasses
    # atom sharding refuses the top-k formats (a global op over the atoms);
    # every neighbor mode is ported, a cell flow without its capacities and
    # an unknown mode are errors
    from enflow_tpu_torch.flow.sharded import _sharded_cfg
    from enflow_tpu_torch.parallel.collectives import VirtualAxis
    for kw in (dict(nbr_mode="topk"), dict(nbr_capacity=4)):
        with pytest.raises(ValueError, match="atom-sharded"):
            _sharded_cfg(dataclasses.replace(tcfg, **kw), VirtualAxis(2))
    for kw, msg in ((dict(nbr_mode="cell"), "cell_capacity"),
                    (dict(nbr_mode="ring"), "unknown nbr_mode")):
        with pytest.raises(ValueError, match=msg):
            forward_core(tp, dataclasses.replace(tcfg, **kw), tsys)


def test_init_flow_layout_matches_jax():
    jcfg, tcfg = _cfgs(True)
    jl = jax.tree_util.tree_leaves(j_init_flow(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    tl, _ = tree_flatten(init_flow(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu"))
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    assert all(t.dtype == torch.float32 for t in tl)


@pytest.mark.parametrize("make", [
    lambda: init_flow(torch.Generator().manual_seed(0), _cfgs(True)[1]),
    lambda: init_egcl(torch.Generator().manual_seed(0), EGCLConfig(NF, H)),
    lambda: init_mlp(torch.Generator().manual_seed(0), [NF, H, 1]),
    lambda: init_argmax(torch.Generator().manual_seed(0), NF, H),
    lambda: from_jax_params({"w": np.ones((2, 3), np.float32)}),
], ids=["init_flow", "init_egcl", "init_mlp", "init_argmax",
        "from_jax_params"])
def test_constructors_default_to_the_card(make):
    """Without ``device``, parameters go to ``cuda``; with no card that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        leaves, _ = tree_flatten(make())
        assert all(t.is_cuda for t in leaves)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_checkpoint_from_jax(tmp_path):
    jcfg, tcfg = _cfgs(True)
    jp = j_init_flow(jax.random.PRNGKey(4), jcfg, jnp.float64)
    path = str(tmp_path / "flow.cpt")
    save_checkpoint(path, {"params": jp}, {"epoch": 0, "node_nf": NF})
    template = init_flow(torch.Generator().manual_seed(9), tcfg,
                         torch.float64, "cpu")
    tree, hp = load_checkpoint(path, {"params": template})
    assert hp["node_nf"] == NF
    jsys, tsys = _state(seed=3)
    jout, jldj = j_forward_core(jp, jcfg, jsys)
    tout, tldj = forward_core(tree["params"], tcfg, tsys)
    _close(tout, jout, 1e-10, 1e-10)
    np.testing.assert_allclose(tldj.numpy(), np.asarray(jldj), rtol=1e-10)

    # wrong leaf count, then wrong shapes
    bad = str(tmp_path / "bad.cpt")
    save_checkpoint(bad, {"params": {"networks": jp["networks"]}}, {})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(bad, {"params": template})
    jcfg_w = JFlowConfig(n_iter=2, dt=0.05, nbr_mode="all_pairs",
                         egcl=JEGCLConfig(NF, 2 * H))
    save_checkpoint(bad, {"params": j_init_flow(jax.random.PRNGKey(4),
                                                jcfg_w, jnp.float64)}, {})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(bad, {"params": template})
