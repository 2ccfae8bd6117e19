"""Port parity: the EGCL variants ``attention``, ``norm_diff`` and
``tanh``, and the rule that routes them.

- The port's plain EGCL with each flag, and with all three, against
  ``enflow_tpu.nn.egcl.apply_egcl`` at float64, in ``all_pairs`` mode and
  on a gathered ``images`` neighbor list (tolerance: float64 round-off,
  1e-10 relative).
- ``plain_route``: flagged EGCLs with ``use_pallas`` off go to the plain
  path (on the card as on the CPU), unflagged ones and ``use_pallas`` ones
  to the kernels, which keep refusing the flags.

Inputs and parameters are made with numpy / ``jax.random`` from a seed,
and the parameters carried across with ``utils/jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.data.neighbors import neighbors_with_diffs as j_nbrs
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import apply_egcl as j_apply_egcl
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl

from enflow_tpu_torch.data.neighbors import neighbors_with_diffs
from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow.integrators import FlowConfig, _egcl_at
from enflow_tpu_torch.nn import egcl as egcl_mod
from enflow_tpu_torch.nn.egcl import EGCLConfig, apply_egcl, plain_route
from enflow_tpu_torch.ops import edge_pipeline as ep
from enflow_tpu_torch.ops import egcl_allpairs as ea
from enflow_tpu_torch.utils.jax_params import from_jax_params

B, N, NF, H = 4, 5, 3, 16
FLAGS = {"attention": dict(attention=True), "norm_diff": dict(norm_diff=True),
         "tanh": dict(tanh=True),
         "all": dict(attention=True, norm_diff=True, tanh=True)}


def _state(seed, box_len):
    rng = np.random.default_rng(seed)
    box = np.full((B, 3), box_len)
    pos = rng.uniform(-1.5, 1.5, size=(B, N, 3))
    h = rng.normal(size=(B, N, NF))
    mask = np.ones((B, N), bool)
    mask[1, -1] = False
    pos[~mask] = 0.0
    h[~mask] = 0.0
    return h, pos, box, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["all_pairs", "images"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_flagged_egcl_matches_jax_f64(mode, flag):
    all_pairs = mode == "all_pairs"
    h, pos, box, mask = _state(7, 1e3 if all_pairs else 3.0)
    r_cut = np.full((B,), 1e2 if all_pairs else 2.5)
    cap = None if all_pairs else 24
    jn, jd = j_nbrs(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(mask),
                    jnp.asarray(r_cut), capacity=cap, mode=mode)
    jcfg = JEGCLConfig(NF, H, **FLAGS[flag])
    jp = j_init_egcl(jax.random.PRNGKey(11), jcfg, jnp.float64)
    want = j_apply_egcl(jp, jcfg, jnp.asarray(h), jd, jn.idx, jn.mask,
                        jnp.asarray(mask), all_pairs=all_pairs)
    tp = from_jax_params(jp, device="cpu")
    assert ("att_nn" in tp) == bool(jcfg.attention)
    assert ("coords_range" in tp) == bool(jcfg.tanh)
    tn, td = neighbors_with_diffs(_t(pos), _t(box), _t(mask), _t(r_cut),
                                  cap, mode)
    egcl_mod.counts.reset()
    ep.counts.reset()
    got = apply_egcl(tp, EGCLConfig(NF, H, **FLAGS[flag]), _t(h), td,
                     tn.idx, tn.mask, _t(mask), all_pairs=all_pairs)
    assert egcl_mod.counts.plain_calls == 1
    assert ep.counts.plain_fwd_calls == 0
    for g, w, name in zip(got, want, "QFG"):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12, err_msg=f"{flag} {mode} {name}")


@pytest.mark.parametrize("flag", list(FLAGS))
def test_plain_route_follows_the_config(flag):
    cfg = EGCLConfig(NF, H, **FLAGS[flag])
    assert plain_route(cfg)
    for use_pallas in (True, "v1", "v2", "v3"):
        assert not plain_route(EGCLConfig(NF, H, use_pallas=use_pallas,
                                          **FLAGS[flag]))
    for use_pallas in (False, True, "v3"):
        assert not plain_route(EGCLConfig(NF, H, use_pallas=use_pallas))


def _sys(seed):
    h, pos, box, mask = _state(seed, 1e3)
    f = lambda a: _t(a).float()
    z = torch.zeros((B, N, 3))
    return System(pos=f(pos), vel=z, h=f(h), g=torch.zeros_like(f(h)),
                  box=f(box), mask=_t(mask), r_cut=torch.full((B,), 1e2))


@pytest.mark.parametrize("egcl,route", [
    (dict(attention=True), "plain"),
    (dict(tanh=True, norm_diff=True), "plain"),
    (dict(use_pallas="v3"), "kernel"),
])
def test_flow_step_takes_the_route(egcl, route):
    """``_egcl_at`` on an all-pairs flow: flagged configs run the plain
    EGCL (its counter moves, the kernel's does not); ``use_pallas: v3``
    runs the kernel's contract (its plain version on the CPU)."""
    cfg = FlowConfig(n_iter=1, dt=0.1, egcl=EGCLConfig(NF, H, **egcl),
                     nbr_mode="all_pairs")
    jp = j_init_egcl(jax.random.PRNGKey(2), JEGCLConfig(NF, H, **{
        k: v for k, v in egcl.items() if k != "use_pallas"}), jnp.float64)
    egcl_mod.counts.reset()
    ea.counts.reset()
    tp = from_jax_params(jp, dtype=torch.float32, device="cpu")
    (Q, F, G), _ = _egcl_at(None, cfg, tp, _sys(3))
    assert torch.isfinite(F).all()
    plain = egcl_mod.counts.plain_calls
    kernel = ea.counts.plain_fwd_calls + ea.counts.fwd_launches
    assert (plain, kernel) == ((1, 0) if route == "plain" else (0, 1))


def test_kernel_paths_still_refuse_flags_under_use_pallas():
    h, pos, box, mask = _state(5, 1e3)
    jp = j_init_egcl(jax.random.PRNGKey(4), JEGCLConfig(NF, H, tanh=True),
                     jnp.float64)
    tn, td = neighbors_with_diffs(_t(pos), _t(box), _t(mask))
    with pytest.raises(ValueError, match="attention"):
        apply_egcl(from_jax_params(jp, device="cpu"),
                   EGCLConfig(NF, H, tanh=True, use_pallas=True), _t(h), td,
                   tn.idx, tn.mask, _t(mask), all_pairs=True)
