"""The bf16 gathered-edge route on Hopper (``csrc/edge_pipeline_sm90.cu``):
what of it runs on the CPU.

- The size rule: bf16 at H = 64 and 128 goes to the Hopper kernels
  (``"sm90"``), float32 keeps the tiled kernels, other widths run
  zero-padded to the next kernel width, and a width no kernel takes
  raises.
- The tile plan the wrapper sizes a launch with (``sm90_plan``,
  ``sm90_tiles``, the walk the kernels mirror): every row in one tile of
  at most 64 rows, every atom's K-sum owned by one warpgroup, its tiles in
  order where an atom spans several (K > 64).
- The plain version (what a CPU tensor runs and what ``chip_smoke.py``
  holds the kernels against) against the Pallas kernels of
  ``enflow_tpu/ops/edge_kernel.py`` in interpret mode at bf16, at the
  Hopper kernels' edge cases: K = 8 and 12 with C = 11 (8 and 5 atoms a
  tile), K = 80 (atoms spanning two tiles), H = 64 and 128, rows beyond the
  +-100 clip, masked slots and a fully masked atom. agg, F_sum, de, dcd and
  the seven parameter gradients at the bf16 tolerance of
  ``test_pipeline_matches_pallas_bf16``: rtol 0.15, atol 0.05 (a bf16 ulp
  where the two round a sum in another order).

Inputs are made with numpy from a seed and fed to both packages; the
weights at these widths are scaled by 1/sqrt(fan-in), as ``init_egcl``
scales them (a width-independent scale makes the parameter gradients sums
of terms far larger than the sums, whose bf16 ulps the absolute tolerance
does not hold).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enflow_tpu.ops.edge_kernel import fused_edge_pipeline as j_pipeline

from enflow_tpu_torch.ops import edge_pipeline as ops

from test_torch_port_edge import NAMES, _pipeline_inputs
from torch_threads import one_torch_thread  # noqa: F401

# the bf16 tolerance of test_pipeline_matches_pallas_bf16
RTOL_BF16, ATOL_BF16 = 0.15, 0.05


# --- the size rule ---------------------------------------------------------

@pytest.mark.parametrize("H", [64, 128])
def test_bf16_takes_the_hopper_route(H):
    assert ops.kernel_for(torch.bfloat16, H) == "sm90"
    assert ops.kernel_for(torch.float32, H) == "tiled"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_other_widths_are_padded(dtype):
    assert ops.padded_width(96) == 128
    assert ops.kernel_for(dtype, 96) == ops.kernel_for(dtype, 128)


@pytest.mark.parametrize("dtype,H", [(torch.bfloat16, 300),
                                     (torch.bfloat16, 0),
                                     (torch.float32, 260),
                                     (torch.float64, 128)])
def test_a_bad_width_or_dtype_still_raises(dtype, H):
    """H < 1 and a dtype other than float32 / bfloat16 raise; a width past
    256 now takes the dtype's column-chunked route."""
    if H > 256:
        assert ops.kernel_for(dtype, H) == ops.XWIDE_ROUTE[dtype]
        return
    with pytest.raises(ValueError, match="float32"):
        ops.kernel_for(dtype, H)


class _Sm90Sizes:
    """A stand-in for the Hopper library's size entry points: e W1 in at
    most four k16 steps (C <= 64), one warpgroup a block at C = 49 .. 64,
    and (as a faulty library would) none at H = 128 past C = 56."""

    def edge_sm90_c_max(self):
        return 64

    def edge_sm90_warpgroups(self, C, H, bwd):
        if C > 64 or (H == 128 and C > 56):
            return 0
        return 1 if C > 48 else (2 if bwd else 3)


@pytest.mark.parametrize("C,H,ok", [(17, 64, True), (33, 128, True),
                                    (64, 64, True), (65, 64, False),
                                    (57, 128, False)])
def test_hopper_route_refuses_wide_edge_rows(C, H, ok):
    """C > 16 takes more k16 steps of e (no refusal at C = 17 or 33); the
    wrapper refuses only a C past the library's limit, naming C and the
    limit, and a library that fits no block at a C within it is an
    internal error (no fallback to another kernel or the plain
    version)."""
    lib = _Sm90Sizes()
    for direction in ("fwd", "bwd"):
        if ok:
            # as many warpgroups as the library says a block of them fits
            assert ops.sm90_warpgroups(lib, C, H, direction) == \
                lib.edge_sm90_warpgroups(C, H, int(direction == "bwd"))
        elif C > 64:
            with pytest.raises(ValueError, match=f"C={C}") as e:
                ops.sm90_warpgroups(lib, C, H, direction)
            assert "C = 2 nf + 1 <= 64" in str(e.value)
        else:
            with pytest.raises(RuntimeError, match=f"C={C} <= 64"):
                ops.sm90_warpgroups(lib, C, H, direction)


# --- the tile plan ---------------------------------------------------------

PLAN_CASES = [(A, K, nwg, n_sm)
              for K in (8, 12, 13, 24, 56, 80)
              for A, nwg, n_sm in ((26624, 3, 132), (1000, 2, 132),
                                   (37, 2, 4))]


@pytest.mark.parametrize("A,K,nwg,n_sm", PLAN_CASES)
def test_tiles_cover_rows_once_and_atoms_have_one_owner(A, K, nwg, n_sm):
    apt, tpa, units, blocks = ops.sm90_plan(A, K, nwg, n_sm)
    assert 1 <= blocks <= n_sm
    assert (blocks - 1) * nwg < units              # no block without a unit
    if K <= ops.SM90_ROWS:
        assert (apt, tpa) == (ops.SM90_ROWS // K, 1)
        assert units == math.ceil(A / apt)
    else:
        assert (apt, tpa, units) == (0, math.ceil(K / ops.SM90_ROWS), A)
    tiles = ops.sm90_tiles(A, K, apt, tpa, units, blocks * nwg)
    assert len(tiles) == blocks * nwg              # one part slice each
    owner, rows = {}, []
    for slot, walk in enumerate(tiles):
        for i, (a0, na, g0, nr) in enumerate(walk):
            assert 1 <= nr <= ops.SM90_ROWS
            assert a0 * K <= g0 and g0 + nr <= (a0 + na) * K
            if apt:
                # whole atoms: the tile's rows are its atoms' rows
                assert (g0, nr) == (a0 * K, na * K) and 1 <= na <= apt
            else:
                # an atom's tiles are consecutive in its warpgroup's walk,
                # so the carried K-sum is added in row order
                t = (g0 - a0 * K) // ops.SM90_ROWS
                assert na == 1 and g0 == a0 * K + t * ops.SM90_ROWS
                if t:
                    assert walk[i - 1][0] == a0
                    assert walk[i - 1][2] + walk[i - 1][3] == g0
            for a in range(a0, a0 + na):
                assert owner.setdefault(a, slot) == slot
            rows += range(g0, g0 + nr)
    assert sorted(owner) == list(range(A))
    assert sorted(rows) == list(range(A * K))      # every row once


def test_plan_at_the_sampler_shape():
    """The top-k sampler (2048 x 13 atoms, K = 8): 8 atoms in every
    64-row tile, no padded row, 3328 tiles over 132 blocks of 3
    forward warpgroups, 8 or 9 tiles each."""
    A, K = 2048 * 13, 8
    apt, tpa, units, blocks = ops.sm90_plan(A, K, 3, 132)
    assert (apt, tpa, units, blocks) == (8, 1, 3328, 132)
    tiles = ops.sm90_tiles(A, K, apt, tpa, units, blocks * 3)
    assert {nr for walk in tiles for _, _, _, nr in walk} == {64}
    assert {len(walk) for walk in tiles} == {8, 9}


@pytest.mark.parametrize("K,rows", [(12, 60), (13, 52), (24, 48), (56, 56)])
def test_whole_atom_tiles_pad_to_64_rows(K, rows):
    """Where 64 / K is not whole the tile's last rows are padding: 5
    atoms of K = 12 fill 60 of the 64 rows."""
    apt, _, _, _ = ops.sm90_plan(1000, K, 2, 132)
    assert apt * K == rows


# --- the plain version against the Pallas kernel at bf16 -------------------

def _bf16_case(A, K, C, H, seed):
    """Forward and VJP of the Pallas kernel (interpret mode) and of the
    port's autograd Function (its plain version on the CPU) at bf16:
    ``[(want, got)]`` for agg, F_sum, then de, dcd and the seven
    parameter gradients."""
    e, cd, em, ws, dagg, dfs = _pipeline_inputs(A, K, C, H, seed)
    fan_in = (C, 1, H, 1, H, 1, H)
    ws = [w / math.sqrt(2.0 * n) for w, n in zip(ws, fan_in)]
    J = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    jargs = [J(e), J(cd)] + [J(w) for w in ws]
    jem = jnp.asarray(em)
    jout, vjp = jax.vjp(lambda a, b, *w: j_pipeline(a, b, jem, *w), *jargs)
    jgrads = vjp((J(dagg), J(dfs)))
    to32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    T = lambda a: torch.from_numpy(to32(a).copy()).to(torch.bfloat16)
    targs = [T(a).requires_grad_(True) for a in jargs]
    tout = ops.fused_edge_pipeline(targs[0], targs[1], torch.from_numpy(em),
                                   *targs[2:])
    tgrads = torch.autograd.grad(tout, targs, (T(J(dagg)), T(J(dfs))))
    return ([(to32(j), t.detach()) for j, t in zip(jout, tout)],
            [(to32(j), t) for j, t in zip(jgrads, tgrads)])


@pytest.mark.parametrize("A,K,C,H", [(6, 8, 11, 64), (5, 12, 11, 128),
                                     (3, 80, 11, 64), (4, 13, 5, 128)])
def test_plain_matches_pallas_bf16_at_the_hopper_edge_cases(A, K, C, H):
    fwd, bwd = _bf16_case(A, K, C, H, A + K)
    for (want, got), name in zip(fwd + bwd, ("agg", "F_sum") + NAMES):
        assert got.dtype == torch.bfloat16, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16, err_msg=name)
    assert float(fwd[0][1][1].abs().max()) == 0.0        # the masked atom
    assert float(fwd[1][1][1].abs().max()) == 0.0


def test_plain_parameter_gradients_are_float32_sums():
    """The plain backward returns the parameter gradients as float32 sums
    (what chip_smoke.py compares the kernels' with); the autograd Function
    rounds each to its weight's dtype."""
    A, K, C, H = 5, 8, 11, 64
    e, cd, em, ws, dagg, dfs = _pipeline_inputs(A, K, C, H, 7)
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16)
    args = [T(e).requires_grad_(True), T(cd)]
    W = [T(w).requires_grad_(True) for w in ws]
    emt = torch.from_numpy(em).to(torch.bfloat16)
    sums = ops.edge_pipeline_plain_bwd(args[0].detach(), args[1], emt,
                                       *[w.detach() for w in W], T(dagg),
                                       T(dfs))
    assert sums[0].dtype == sums[1].dtype == torch.bfloat16     # de, dcd
    assert all(g.dtype == torch.float32 for g in sums[2:])
    agg, fs = ops.fused_edge_pipeline(args[0], args[1], torch.from_numpy(em),
                                      *W)
    grads = torch.autograd.grad((agg, fs), W, (T(dagg), T(dfs)))
    for g, s, w in zip(grads, sums[2:], W):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.equal(g, s.to(torch.bfloat16))
