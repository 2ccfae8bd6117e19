"""Port parity: the float32 all-pairs EGCL at 128 < H <= 256.

``ops/egcl_allpairs.py`` sends float32 at the padded widths 192 and 256
(``ops.padded_width``; 128 < H < 192 and 192 < H < 256 zero-padded up) to
the f32 block-pair kernels of ``csrc/egcl_allpairs_f32.cu`` with W2 and W3
streamed through a ring of two slabs in shared memory (route
``"f32_wide"``, every N). A slab is one K-split of a product: 64 of W's
rows for X W, 64 of W's columns for X W^T, each 16-byte chunk kc of its row
r at kc ^ ((r / 4) % 8). K2 p keeps dW2 and dW3 in the block's slice of the
partials in global memory, read, added to and written once a row tile, a
64-column group at a time. Here, on the CPU:

- (a) the route rule: every direction of float32 at H = 130, 160, 192, 200
  and 256 goes to ``"f32_wide"`` at the padded width at every N, no width
  up to 256 is refused in either dtype, H > 256 is refused naming ROADMAP
  B7; the new counters, and the wrapper's padding with its launch replaced
  by the plain version;
- (b) the slab schedule emulated in plain PyTorch at H = 192 and 256: the
  slabs filled as ``issue_slab`` fills them and read back at the addresses
  ``product_slab`` reads, taken in the stream's order through a ring of
  two slots over the f32 block-pair schedule at the plan's atoms a block
  and rows a tile (``f32_blocks_*`` of ``test_torch_port_egcl_f32_blocks``),
  with K2 p's dW2 / dW3 accumulated in 64-column groups of the blocks'
  slices, against the plain version at float64 to 1e-10; a ring of one slot
  fails;
- (c) the kernels' shared-memory arithmetic (``carve_rows``,
  ``carve_pairs``) mirrored in Python: the plan at 192 and 256 fits in
  232,448 bytes in every direction, and at H = 128 the mirror gives the
  plan the card's library gives;
- (d) the slice as a whole: the ala2 flow-VI loss and its parameter
  gradients at ``hidden_nf`` 192 against the JAX package's, float64;
- (e) the plain version at H = 192 and 256 against the v3 Pallas kernel in
  interpret mode at float32, forward and backward with the parameter
  gradients.

The kernels themselves run on the card only (``chip_smoke.py``, phases
kernel and wide_f32). Inputs are made with numpy from a seed: ragged
masks, a molecule with one real atom and one with none.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_egcl_f32_blocks import (_bwd_rows, f32_block_schedule,
                                             f32_blocks_bwd, f32_blocks_fwd)
from test_torch_port_egcl_wide import _args, _close, _weights

from enflow_tpu.data.system import System as JSystem
from enflow_tpu.flow import FlowConfig as JFlowConfig
from enflow_tpu.flow import init_flow as j_init_flow
from enflow_tpu.nn.egcl import EGCLConfig as JEGCLConfig
from enflow_tpu.nn.egcl import init_egcl as j_init_egcl
from enflow_tpu.ops.egcl_fused_v3 import fused_allpairs_edges_v3
from enflow_tpu.sample import forcefield as jff
from enflow_tpu.sample.vi import flow_vi_loss as j_flow_vi_loss
from enflow_tpu.sample.vi import make_system_target as j_system_target

from enflow_tpu_torch.data.system import System
from enflow_tpu_torch.flow import FlowConfig
from enflow_tpu_torch.nn.egcl import EGCLConfig
from enflow_tpu_torch.ops import egcl_allpairs as ops
from enflow_tpu_torch.sample import forcefield as tff
from enflow_tpu_torch.sample.vi import flow_vi_loss, make_system_target
from enflow_tpu_torch.utils.jax_params import from_jax_params, tree_flatten
from torch_threads import one_torch_thread  # noqa: F401

LIMIT = 232448                   # shared memory a block may use
SLAB = 64                        # k of a product a slab holds (kSlab)
RING = 2                         # slabs the ring holds (kRing)
BLOCKS = 3                       # blocks of threads (parameter slices)
WIDTHS = (130, 160, 192, 200, 256)
DIRECTIONS = ("fwd", "bwd", "bwd_params")


# ---------------------------------------------------------------------------
# (a) the route rule and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("H", WIDTHS)
def test_route_rule_sends_f32_wide_widths_to_the_new_route(H, direction):
    """float32 at 128 < H <= 256: ``"f32_wide"`` at every N (no
    one-molecule limit to ask the library for), at the padded width; bf16
    there stays on ``"wide"``."""
    Hp = ops.padded_width(H)
    assert Hp in ops.WIDE_H and Hp >= H
    assert ops.kernel_for(0, H, direction) == "f32_wide"
    assert ops.kernel_for(1, H, direction) == "wide"
    for N in (13, 22, 147, 561):
        assert ops.route_for(N, 5, H, 0, direction, 0) == "f32_wide"
        assert ops._check_fits(0, (2, N, 5, H), direction) == "f32_wide"
    with pytest.raises(ValueError, match="no one-molecule limit"):
        ops._smem(0, 22, 4, Hp, direction)


def test_no_width_up_to_256_is_refused():
    """Every width 1 .. 256 has a route in both dtypes and every
    direction; past 256 both dtypes take the column-chunked kernels, and
    only past ``XWIDE_MAX_H`` refuse, naming ROADMAP B7.5."""
    for code in (0, 1):
        for H in range(1, 257):
            for direction in DIRECTIONS:
                assert ops.kernel_for(code, H, direction) in (
                    "f32", "f32_wide", "sm90", "wide")
                for N in (13, 5000):
                    ops.route_for(N, 5, H, code, direction, 40)
        for H in (257, 320):
            assert ops._check_fits(code, (2, 13, 5, H), "bwd_params") == \
                ops.XWIDE_ROUTE[code]
        with pytest.raises(ValueError, match="B7.5") as e:
            ops._check_fits(code, (2, 13, 5, ops.XWIDE_MAX_H + 1),
                            "bwd_params")
        assert ops.XWIDE_ITEM in str(e.value)


@pytest.mark.parametrize("direction,name", [
    ("fwd", "fwd_f32_wide_launches"), ("bwd", "bwd_f32_wide_launches"),
    ("bwd_params", "bwd_param_f32_wide_launches")])
def test_f32_wide_counters(direction, name):
    """Each launch on its own counter, a padded one on ``padded_launches``
    too; no other counter moves."""
    ops.counts.reset()
    ops._count(direction, 256, "f32_wide")
    ops._count(direction, 200, "f32_wide")
    got = {k: v for k, v in vars(ops.counts).items()
           if not k.startswith("_") and v}
    assert got == {name: 2, "padded_launches": 1}
    ops.counts.reset()


def test_f32_wide_launch_failure_names_the_route():
    class Lib:
        def egcl_f32_error_string(self, err):
            return b"invalid argument"
    with pytest.raises(RuntimeError, match="invalid argument.*f32_wide"):
        ops._raise_on(Lib(), 1, "forward", (2, 22, 4, 256), "f32_wide")


@pytest.mark.parametrize("H", [160, 192, 200, 256])
def test_wrapper_runs_f32_wide_at_the_padded_width(monkeypatch, H):
    """The wrapper with its launch (``_run``) replaced by the plain
    version: every direction reaches ``"f32_wide"`` at the padded width
    (dagg padded too), the outputs come back at H equal to the unpadded
    plain call (1e-5 of each output's largest value: the products sum
    other zeros in float32), on the new counters."""
    seen = []

    def run(direction, rt, h, pos, box, mask_f, weights, dagg, dfsum):
        seen.append((direction, rt, weights[4].shape[1],
                     None if dagg is None else dagg.shape[-1]))
        if direction == "fwd":
            return ops.allpairs_edges_plain(h, pos, box, mask_f, weights)
        return ops.allpairs_edges_plain_bwd(h, pos, box, mask_f, weights,
                                            dagg, dfsum,
                                            direction == "bwd_params")

    monkeypatch.setattr(ops, "_run", run)
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(9, 4, 5, H, H,
                                                 torch.float32)
    Hp = ops.padded_width(H)
    ops.counts.reset()
    got = (ops._launch("fwd", h, pos, box, mf, W)
           + ops._launch("bwd", h, pos, box, mf, W, dagg, dfsum)
           + ops._launch("bwd_params", h, pos, box, mf, W, dagg, dfsum))
    assert seen == [("fwd", "f32_wide", Hp, None),
                    ("bwd", "f32_wide", Hp, Hp),
                    ("bwd_params", "f32_wide", Hp, Hp)]
    want = (ops.allpairs_edges_plain(h, pos, box, mf, W)
            + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum)
            + ops.allpairs_edges_plain_bwd(h, pos, box, mf, W, dagg, dfsum,
                                           params=True))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    c = {k: v for k, v in vars(ops.counts).items()
         if not k.startswith("_") and v}
    want_c = {"fwd_f32_wide_launches": 1, "bwd_f32_wide_launches": 1,
              "bwd_param_f32_wide_launches": 1}
    if Hp != H:
        want_c["padded_launches"] = 3
    assert c == want_c
    ops.counts.reset()


# ---------------------------------------------------------------------------
# (b) the slab schedule
# ---------------------------------------------------------------------------

def slab_fill(H, trans):
    """``(dst, rows, cols)``: slab float ``dst`` takes W[64 g + rows, cols]
    (X W: 64 of W's rows, [SLAB, H]) or W[rows, 64 g + cols] (X W^T: 64 of
    W's columns, [H, SLAB]), as ``issue_slab`` copies them, four floats a
    16-byte chunk, chunk kc of row r at kc ^ ((r / 4) % 8)."""
    CH = (SLAB if trans else H) // 4
    k = np.arange((H if trans else SLAB) * CH)
    r, kc = k // CH, k % CH
    base = r * 4 * CH + ((kc ^ ((r >> 2) & 7)) << 2)
    e = np.arange(4)
    return ((base[:, None] + e).ravel(), np.repeat(r, 4),
            (4 * kc[:, None] + e).ravel())


def slab_read(H, trans):
    """[SLAB, H]: the slab float that ``product_slab`` reads as B[k, n] of
    the slab's K-split (out += X[:, 64 g + k] B[k, n]): X W reads
    W[4 kc + j][4 cx + u] at (4 kc + j) H + ((cx ^ (kc % 8)) << 2) + u,
    X W^T W[4 cx + j][4 kc + u] at (4 cx + j) SLAB + ((kc ^ (cx % 8)) << 2)
    + u."""
    k = np.arange(SLAB)[:, None]
    n = np.arange(H)[None, :]
    if trans:
        return n * SLAB + (((k // 4) ^ ((n // 4) & 7)) << 2) + k % 4
    return k * H + (((n // 4) ^ ((k // 4) & 7)) << 2) + n % 4


class SlabRing:
    """The kernels' ring of RING slabs: slab s of the stream is product
    (s / G) % nprod (W2 X W, W3 X W, W3 X W^T, W2 X W^T) and its k 64 (s %
    G) ..; slab s + RING - 1 is issued into slot s + RING - 1 mod RING when
    slab s is taken (which must not be the slot being read)."""

    def slot(self, s):
        """The kernels' ``slot_of``."""
        return s % RING

    def __init__(self, W2, W3, nprod):
        self.W = {0: W2.numpy(), 1: W3.numpy(), 2: W3.numpy(),
                  3: W2.numpy()}
        self.H = W2.shape[0]
        self.G = self.H // SLAB
        self.nprod = nprod
        self.fill = {tr: slab_fill(self.H, tr) for tr in (False, True)}
        self.read = {tr: slab_read(self.H, tr) for tr in (False, True)}
        self.slots = [None] * RING
        self.tags = [None] * RING
        self.s = 0
        self.used = []
        for s in range(RING - 1):
            self.issue(s)

    def issue(self, s):
        prod, g = (s // self.G) % self.nprod, s % self.G
        dst, rows, cols = self.fill[prod >= 2]
        buf = np.full(SLAB * self.H, np.nan)
        W = self.W[prod]
        buf[dst] = (W[rows, SLAB * g + cols] if prod >= 2
                    else W[SLAB * g + rows, cols])
        assert not np.isnan(buf).any()          # every float written once
        self.slots[self.slot(s)] = buf
        self.tags[self.slot(s)] = s

    def take(self):
        s = self.s
        assert self.tags[self.slot(s)] == s
        nxt = s + RING - 1
        # the next slab's copy never lands in the slot being read
        assert self.slot(nxt) != self.slot(s) or nxt == s
        self.issue(nxt)
        self.s += 1
        self.used.append(((s // self.G) % self.nprod, s % self.G))
        return self.slots[self.slot(s)]

    def product(self, X, prod):
        """X [.., H] times W (prod 0, 1) or W^T (2, 3), slab by slab, the
        slabs' K-splits summed in k order."""
        out = torch.zeros(X.shape[:-1] + (self.H,), dtype=X.dtype)
        for g in range(self.G):
            want = ((self.s // self.G) % self.nprod, self.s % self.G)
            assert want == (prod, g), (want, prod, g)
            B = torch.from_numpy(self.take()[self.read[prod >= 2]])
            out = out + X[..., SLAB * g:SLAB * (g + 1)] @ B
        return out


@pytest.mark.parametrize("H", [192, 256])
def test_slab_layout_reads_back_w(H):
    """Every slab of both products, read at ``product_slab``'s addresses,
    is its K-split of W (X W) or W^T (X W^T), every element of W read once
    over the G slabs."""
    W = np.arange(H * H, dtype=np.float64).reshape(H, H)
    for trans in (False, True):
        dst, rows, cols = slab_fill(H, trans)
        assert sorted(dst.tolist()) == list(range(SLAB * H))
        seen = np.zeros((H, H), int)
        for g in range(H // SLAB):
            buf = np.full(SLAB * H, np.nan)
            buf[dst] = (W[rows, SLAB * g + cols] if trans
                        else W[SLAB * g + rows, cols])
            B = buf[slab_read(H, trans)]
            k = SLAB * g + np.arange(SLAB)[:, None]
            n = np.arange(H)[None, :]
            np.testing.assert_array_equal(B, W[n, k] if trans else W[k, n])
            if trans:
                seen[n, k] += 1
            else:
                seen[k, n] += 1
        assert (seen == 1).all()


def _streamed_dot(monkeypatch, ring, W2, W3):
    """``ops._dot`` with the products by W2 / W3 (and their transposes)
    taken slab by slab from ``ring``; every other product as before."""
    plain = ops._dot

    def dot(a, b, out_dtype):
        for W, prods in ((W2, (0, 3)), (W3, (1, 2))):
            if b.data_ptr() == W.data_ptr() and b.shape == W.shape:
                trans = b.stride() != W.stride()
                return ring.product(a.to(torch.float64),
                                    prods[int(trans)]).to(out_dtype)
        return plain(a, b, out_dtype)

    monkeypatch.setattr(ops, "_dot", dot)


def wide_bwd_params(args, dagg, dfsum, A, R):
    """``f32_blocks_bwd(..., params=True)`` with dW2 and dW3 kept as the
    wide K2 p keeps them: each row tile's outer products added into its
    item's rows of the block's slice one 64-column group at a time (read,
    add the tile's rows in order, write back); the blocks' slices summed
    in order. The other gradients as ``f32_blocks_bwd`` takes them.
    Returns ``(dW2, dW3)`` and the 64-column groups each tile visited."""
    h, pos, box, mask_f, W = args
    Bm, N, _ = h.shape
    Hd = W[4].shape[1]
    f = lambda t: t.to(torch.float64)
    nI = math.ceil(N / A)
    item = {k: torch.zeros((Bm, nI, Hd, Hd), dtype=torch.float64)
            for k in ("dW2", "dW3")}
    groups = []
    for ib, (i0, ni, pairs) in enumerate(f32_block_schedule(N, A, R)):
        for j0, nj, tiles in pairs:
            for g0, nr, li, lj, live in tiles:
                r = _bwd_rows(args, dagg, dfsum, i0 + li, j0 + lj, live)
                visited = []
                for name, L, G in (("dW3", r["m2"], r["dz3"]),
                                   ("dW2", r["m1"], r["dz2"])):
                    for b in range(Hd // SLAB):
                        cols = slice(SLAB * b, SLAB * (b + 1))
                        acc = item[name][:, ib, :, cols].clone()
                        acc += torch.einsum("brk,brn->bkn", f(L[:, :nr]),
                                            f(G[:, :nr, cols]))
                        item[name][:, ib, :, cols] = acc
                        visited.append((name, b))
                groups.append(visited)
    tot = []
    for k in ("dW2", "dW3"):
        flat = item[k].reshape((Bm * nI, Hd, Hd))     # items in it order
        tot.append(torch.stack([flat[g::BLOCKS].sum(0)
                                for g in range(BLOCKS)]).sum(0))
    return tot, groups


class StubF32Lib:
    """The library's block-pair shared-memory arithmetic (``carve_rows``
    and ``carve_pairs`` of egcl_allpairs_f32.cu, 16-byte aligned takes)
    mirrored in Python: the resident widths (64, 128) hold W2 and W3
    whole, the streamed ones (192, 256) a ring of RING slabs of SLAB H
    floats."""

    def egcl_f32_smem_limit(self):
        return LIMIT

    def egcl_f32_blocks_smem_bytes(self, A, nf, H, R, kind):
        qmax = {0: 9, 1: 9, 2: 5}[kind]
        if (H not in (64, 128, 192, 256) or A < 1 or nf < 1 or R < 8
                or R % 8 or R > 8 * qmax):
            return -1
        off = 0

        def take(n):
            nonlocal off
            off = (off + 15) // 16 * 16 + n
        bwd, inn = kind != 0, kind == 1
        if H in (64, 128):
            take(4 * H * H)
            take(4 * H * H)
        else:
            take(4 * H * SLAB * RING)
        take(4 * H * nf)
        take(4 * H * nf)
        for _ in range(5):
            take(4 * H)
        for _ in range(3 if kind == 2 else 2):
            take(4 * R * (H + 4))
        take(4 * R * (H // 32) * (2 * nf + 1 if inn else 1))
        for n in (4, 4, 12, 4, 4):              # ri, rj, cd, r2, valid
            take(n * R)
        take(4 * R * (2 * nf + 3 if inn else 3))
        sides = 2 if bwd else 1
        take(4 * A * sides * (nf + 3 if inn else H))
        if not inn:
            take(4 * A * 3 * sides)
        take(4 * (2 * A * nf + 2 * A * 3 + 2 * A + 4 + (3 * A if bwd else 0)))
        return off


def _plan(N, nf, H, direction):
    return ops._f32_blocks_launch_plan(StubF32Lib(), N, nf, H, direction)


@pytest.mark.parametrize("H", [192, 256])
def test_streamed_schedule_matches_plain_f64(monkeypatch, H):
    """The f32 block-pair schedule at the plan's atoms a block and rows a
    tile (N=30, nf=5) with every W2 / W3 product streamed through the ring
    (stream order, each slab's K-split as ``product_slab`` reads it), and
    K2 p's dW2 / dW3 accumulated in 64-column groups of the slices, against
    the plain version at float64: forward, input gradients and the nine
    parameter gradients to 1e-10 of each output's largest value; the
    stream visits (product, slab) in order, tile after tile."""
    N = 30
    (h, pos, box, mf, W), dagg, dfsum, _ = _args(N, 4, 5, H, H + N)
    args = (h, pos, box, mf, W)
    G = H // SLAB
    want = {"fwd": ops.allpairs_edges_plain(*args),
            "bwd": ops.allpairs_edges_plain_bwd(*args, dagg, dfsum),
            "bwd_params": ops.allpairs_edges_plain_bwd(*args, dagg, dfsum,
                                                       params=True)}
    for direction in DIRECTIONS:
        A, R = _plan(N, 5, H, direction)
        assert A % 8 == 0 and R % 8 == 0
        nprod = 2 if direction == "fwd" else 4
        ring = SlabRing(W[4], W[6], nprod)
        with monkeypatch.context() as m:
            _streamed_dot(m, ring, W[4], W[6])
            if direction == "fwd":
                got = f32_blocks_fwd(*args, A, R)
            elif direction == "bwd":
                got = f32_blocks_bwd(args, dagg, dfsum, A, R)
            else:
                got = f32_blocks_bwd(args, dagg, dfsum, A, R, params=True)
                n_used = len(ring.used)
                (dW2, dW3), groups = wide_bwd_params(args, dagg, dfsum, A, R)
                got = got[:6] + (dW2,) + got[7:8] + (dW3,) + got[9:]
                assert len(ring.used) == 2 * n_used
                assert groups and all(
                    v == [(k, b) for k in ("dW3", "dW2") for b in range(G)]
                    for v in groups)
        assert ring.used and len(ring.used) % (nprod * G) == 0
        assert ring.used == [(p, g) for p in range(nprod)
                             for g in range(G)] * (len(ring.used)
                                                   // (nprod * G))
        assert len(got) == len(want[direction])
        for g, w in zip(got, want[direction]):
            assert np.abs(w.numpy()).max() > 0
            _close(g, w, 1e-10)


def test_ring_of_one_slot_overwrites_the_slab_in_use():
    """The emulated ring notices every slab in one slot while the copies
    still run a slab ahead (chip_mutants.py's "a ring of one slot"): the
    next slab's copy would land in the slab being read."""
    class OneSlot(SlabRing):
        def slot(self, s):
            return 0
    W = _weights(5, 192, 1)
    ring = SlabRing(W[4], W[6], 2)
    ring.take()
    ring = OneSlot(W[4], W[6], 2)
    with pytest.raises(AssertionError):
        ring.take()


# ---------------------------------------------------------------------------
# (c) the shared-memory arithmetic
# ---------------------------------------------------------------------------

# the plans at the main path's shapes (ala2: N=22, nf=4) and at LJ147
# (nf=5): (atoms a block, rows a row tile)
WIDE_PLANS = {
    (192, 4, 22): {"fwd": (16, 64), "bwd": (24, 64), "bwd_params": (16, 40)},
    (256, 4, 22): {"fwd": (16, 32), "bwd": (24, 32), "bwd_params": (16, 16)},
    (192, 5, 147): {"fwd": (16, 64), "bwd": (24, 56), "bwd_params": (8, 32)},
    (256, 5, 147): {"fwd": (8, 32), "bwd": (24, 32), "bwd_params": (16, 16)},
}


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("H,nf,N", sorted(WIDE_PLANS))
def test_wide_plan_fits(H, nf, N, direction):
    """The plan at H = 192 / 256: the most rows a tile (a multiple of 8,
    cut evenly over a block pair's rows) at which a block of 8 atoms fits,
    the most atoms beside them, in 232,448 bytes with the ring; and the
    ring's two slabs are the room a resident W2 + W3 would not leave."""
    lib = StubF32Lib()
    kind = ops._KIND[direction]
    A, R = _plan(N, nf, H, direction)
    assert (A, R) == WIDE_PLANS[(H, nf, N)][direction]
    need = lib.egcl_f32_blocks_smem_bytes(A, nf, H, R, kind)
    assert 0 < need <= LIMIT
    rows = max(r for r in range(8, ops.F32_ROWS_MAX[direction] + 1, 8)
               if 0 < lib.egcl_f32_blocks_smem_bytes(8, nf, H, r, kind)
               <= LIMIT)
    assert R == ops.tile_rows(rows, A * A)
    assert need + 8 * H * H - 4 * RING * SLAB * H > LIMIT


def test_stub_gives_the_cards_plan_at_128():
    """At H = 128 (W2 and W3 resident) the mirror gives the plan that the
    card's library gives at LJ147 (PERF.md: blocks of 32 atoms and 64-row
    tiles forward, 24 atoms backward)."""
    got = {d: _plan(147, 5, 128, d) for d in DIRECTIONS}
    assert got == {"fwd": (32, 64), "bwd": (24, 64), "bwd_params": (24, 40)}
    lib = StubF32Lib()
    assert lib.egcl_f32_blocks_smem_bytes(8, 5, 320, 8, 0) == -1


# ---------------------------------------------------------------------------
# (d) the slice as a whole: ala2's flow-VI loss at hidden_nf 192
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent
ALA2 = yaml.safe_load((ROOT / "example" / "ala2_ff.yaml").read_text())


def test_flow_vi_loss_on_ala2_at_192_matches_jax_f64():
    """vi_ala2.yaml's loss (the ala2 force field, e_cap 500; N=22, nf=4)
    and every parameter gradient at ``hidden_nf`` 192, two particles,
    against the JAX package at float64 (1e-9)."""
    NF, H, P = 4, 192, 2
    kw = dict(n_iter=2, dt=0.05, nbr_mode="all_pairs")
    jcfg = JFlowConfig(egcl=JEGCLConfig(NF, H), **kw)
    tcfg = FlowConfig(egcl=EGCLConfig(NF, H), **kw)
    jp = j_init_flow(jax.random.PRNGKey(3), jcfg, jnp.float64)
    rng = np.random.default_rng(7)
    x0 = jff.zmatrix_to_cartesian(ALA2["zmatrix"])
    draws = {"h": rng.normal(size=(P, 22, NF)),
             "g": rng.normal(size=(P, 22, NF)),
             "pos": x0[None] + 0.1 * rng.normal(size=(P, 22, 3)),
             "vel": rng.normal(size=(P, 22, 3))}
    rest = dict(mask=np.ones((P, 22), bool), box=np.full((P, 3), 1e3),
                r_cut=np.full((P,), 1e2))
    jbatch = JSystem(**{k: jnp.asarray(v) for k, v in {**draws,
                                                       **rest}.items()})
    tbatch = System(**{k: torch.from_numpy(v.copy())
                       for k, v in {**draws, **rest}.items()})
    jf = jff.ForceField.from_dict(ALA2, ke=ALA2["coulomb_const"])
    tf = tff.ForceField.from_dict(ALA2, ke=ALA2["coulomb_const"],
                                  device="cpu")
    jt = j_system_target(jff.forcefield_target(jf, 0.59616, 500.0).log_prob)
    tt = make_system_target(tff.forcefield_target(tf, 0.59616,
                                                  500.0).log_prob)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: j_flow_vi_loss(p, jcfg, jbatch, jt)[0]))(jp)
    tp = from_jax_params(jp, device="cpu")
    leaves, _ = tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    tl, _ = flow_vi_loss(tp, tcfg, tbatch, tt)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    assert any(tuple(t.shape[-2:]) == (H, H) for t in leaves)   # W2, W3
    assert np.isfinite(float(jl))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-9)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())


# ---------------------------------------------------------------------------
# (e) the plain version at H = 192 / 256 against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [192, 256])
def test_plain_at_256_matches_pallas_f32(H):
    """``allpairs_edges_plain`` / ``_plain_bwd`` (with the parameter
    gradients) at H, B = 2, N = 6, against ``fused_allpairs_edges_v3`` in
    interpret mode and its VJP at float32: forward at rtol 2e-5 / atol
    2e-6, dh / dpos and the nine parameter gradients at rtol 5e-5 / atol
    5e-6 of their largest value (test_torch_port_egcl.py's f32
    tolerances)."""
    nf, N, Bm = 4, 6, 2
    jp = j_init_egcl(jax.random.PRNGKey(H), JEGCLConfig(nf, H), jnp.float32)
    rng = np.random.default_rng(H + 1)
    mask = np.ones((Bm, N), bool)
    mask[1, -2:] = False
    f32 = lambda a: np.asarray(a, np.float32)
    h = f32(rng.normal(size=(Bm, N, nf)) * mask[..., None])
    pos = f32(rng.normal(size=(Bm, N, 3)) * mask[..., None])
    box = np.full((Bm, 3), 1e3, np.float32)
    box[1] = 4.0
    c_agg = f32(rng.normal(size=(Bm, N, H)))
    c_fs = f32(rng.normal(size=(Bm, N, 3)))
    jbox, jmask = jnp.asarray(box), jnp.asarray(mask)

    def jloss(p, hh, pp):
        a, f, _ = fused_allpairs_edges_v3(p, hh, pp, jbox, jmask)
        return (a * c_agg).sum() + (f * c_fs).sum()

    ja, jf, _ = fused_allpairs_edges_v3(jp, jnp.asarray(h), jnp.asarray(pos),
                                        jbox, jmask)
    jg, jgh, jgp = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(h), jnp.asarray(pos))
    t = lambda a: torch.from_numpy(np.array(a))
    W1, b1 = t(jp["edge_nn"][0]["w"]), t(jp["edge_nn"][0]["b"])
    W1a, W1b, w1r, b1r = ops.split_params(W1, b1, nf)
    W = (W1a, W1b, w1r, b1r, t(jp["edge_nn"][1]["w"]),
         t(jp["edge_nn"][1]["b"])[None], t(jp["coord_nn"][0]["w"]),
         t(jp["coord_nn"][0]["b"])[None], t(jp["coord_nn"][1]["w"]))
    args = (t(h), t(pos), t(box), t(mask).to(torch.float32), W)
    agg, fsum = ops.allpairs_edges_plain(*args)
    dh, dpos, *pgrads = ops.allpairs_edges_plain_bwd(
        *args, t(c_agg), t(c_fs), params=True)
    assert agg.shape == (Bm, N, H)
    for got, want in ((agg, ja), (fsum, jf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-6)
    for got, want in ((dh, jgh), (dpos, jgp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                                   atol=5e-6)
    jW1 = np.asarray(jg["edge_nn"][0]["w"])
    jparams = [jW1[:nf], jW1[nf:2 * nf], jW1[2 * nf:2 * nf + 1],
               np.asarray(jg["edge_nn"][0]["b"])[None],
               np.asarray(jg["edge_nn"][1]["w"]),
               np.asarray(jg["edge_nn"][1]["b"])[None],
               np.asarray(jg["coord_nn"][0]["w"]),
               np.asarray(jg["coord_nn"][0]["b"])[None],
               np.asarray(jg["coord_nn"][1]["w"])]
    for g, w in zip(pgrads, jparams):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-5,
                                   atol=5e-6 * np.abs(w).max())
