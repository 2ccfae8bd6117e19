"""The all-pairs EGCL kernels' shared-memory arithmetic, mirrored in Python.

Each function repeats, take by take, a carve of ``enflow_tpu_torch/csrc``:
``carve_blk`` and ``carve_wg`` of ``egcl_allpairs_sm90.cu`` (bf16: one
molecule a warpgroup, or with ``blocks`` an atom block of the block-pair
kernels) and ``carve_rows``, ``carve`` and ``carve_pairs`` of
``egcl_allpairs_f32.cu`` (float32: molecule tiles of the tiled kernels, or
atom blocks of the block pairs). ``proj`` carves the wide-nf route's block
pairs (nf 0; the f32 input-gradient backward then keeps H-wide dz1 sums).
From them, ``parent_takes`` and ``seam_nf``: the node-feature widths that
the routes before the wide-nf one take, which the tests hold against the
wrapper's route rule and ``chip_smoke.py`` prints beside the libraries'
own answer. Pure Python: no torch, no JAX.
"""

LIMIT = 232448          # kMaxSmem of both libraries
TILE = 64               # kTile, the bf16 kernels' edge rows a tile
RING = 2                # kRing, weight slabs a ring holds (both files)
SLAB = 64               # kSlab, the f32 ring's k a slab
KIND = {"fwd": 0, "bwd": 1, "bwd_params": 2}


class _Bump:
    def __init__(self, align=16):
        self.off, self.align = 0, align

    def take(self, n, align=None):
        a = align or self.align
        self.off = (self.off + a - 1) // a * a + n


def sm90_bytes(N, nf, H, kind, nwg=1, blocks=False):
    """``smem_bytes`` of egcl_allpairs_sm90.cu: the block's weights and
    ``nwg`` warpgroups' arrays of N atoms a side, plus 1024 to align the
    base."""
    streamed = H in (192, 256)
    m = _Bump()
    if not streamed:                                  # carve_blk
        m.take(2 * H * H, 1024)
        m.take(2 * H * H, 1024)
    for _ in range(5):
        m.take(2 * H)
    m.take(4 * nf * H)
    m.take(4 * nf * H)
    m.take(4 * H)
    m.take(4 * H)
    bwd, params = kind != 0, kind == 2
    T, HP, C = 2 * TILE * H, H + 8, H + 4
    for _ in range(nwg):                              # carve_wg
        if streamed:
            m.take(RING * T, 1024)
        m.take(T, 1024)
        m.take(T, 1024)
        if bwd:
            m.take(T, 1024)
        m.take(2 * 8 * TILE, 1024)
        m.take(2 * N * HP)
        m.take(2 * N * HP)
        if kind == 1:
            m.take(2 * N * HP)
        if params:
            m.take(4 * 2 * TILE)
            m.take(4 * 9 * H)
        m.take(2 * TILE)
        m.take(2 * TILE)
        m.take(4 * N * C)
        if bwd:
            m.take(4 * N * C)
        m.take(4 * N * nf)
        m.take(4 * N * 3)
        m.take(4 * N)
        m.take(16)
        if bwd:
            m.take(4 * N * 3)
        if blocks:
            m.take(4 * N * nf)
            m.take(4 * N * 3)
            m.take(4 * N)
    return m.off + 1024


def _f32_rows(m, nf, H, R, kind):
    """``carve_rows`` of egcl_allpairs_f32.cu."""
    inn = kind == 1
    if H in (64, 128):
        m.take(4 * H * H)
        m.take(4 * H * H)
    else:
        m.take(4 * H * SLAB * RING)
    m.take(4 * H * nf)
    m.take(4 * H * nf)
    for _ in range(5):
        m.take(4 * H)
    for _ in range(3 if kind == 2 else 2):
        m.take(4 * R * (H + 4))
    m.take(4 * R * (H // 32) * (2 * nf + 1 if inn else 1))
    for n in (4, 4, 12, 4, 4):                        # ri, rj, cd, r2, valid
        m.take(n * R)
    m.take(4 * R * (2 * nf + 3 if inn else 3))


def f32_tiled_bytes(N, nf, H, kind, MT=1, R=8):
    """``smem_bytes`` of the tiled (one-molecule) f32 kernels (``carve``)."""
    m = _Bump()
    _f32_rows(m, nf, H, R, kind)
    bwd, inn = kind != 0, kind == 1
    na, sides = MT * N, 2 if kind != 0 else 1
    m.take(4 * na * sides * (nf + 3 if inn else H))
    if not inn:
        m.take(4 * na * 3 * sides)
    at_dfs = na * nf + na * 3 + na + MT * 3
    m.take(4 * 2 * ((at_dfs + (na * 3 if bwd else 0) + 3) & ~3))
    return m.off


def f32_pairs_bytes(A, nf, H, R, kind, proj=False):
    """``pairs_smem_bytes`` of the f32 block pairs (``carve_pairs``; with
    ``proj`` the wide-nf route's, nf 0)."""
    if proj:
        nf = 0
    m = _Bump()
    _f32_rows(m, nf, H, R, kind)
    bwd, inn = kind != 0, kind == 1 and not proj
    sides = 2 if bwd else 1
    m.take(4 * A * sides * (nf + 3 if inn else H))
    if not inn:
        m.take(4 * A * 3 * sides)
    m.take(4 * (2 * A * nf + 2 * A * 3 + 2 * A + 4 + (3 * A if bwd else 0)))
    return m.off


def parent_takes(code, N, nf, H, direction):
    """Whether a route before the wide-nf one takes a launch of N atoms at
    this nf and (padded) width H: the one-molecule kernels where H is 64
    or 128 and the molecule fits them (bf16 one warpgroup; f32 one molecule
    and 8 rows), else the block pairs where a block of 8 atoms with one
    warpgroup (bf16) or one row tile of 8 rows (f32) fits. Code 1 is bf16,
    0 float32."""
    kind = KIND[direction]
    if code:
        one = H in (64, 128) and sm90_bytes(N, nf, H, kind) <= LIMIT
        return one or sm90_bytes(8, nf, H, kind, 1, True) <= LIMIT
    one = H in (64, 128) and f32_tiled_bytes(N, nf, H, kind) <= LIMIT
    return one or f32_pairs_bytes(8, nf, H, 8, kind) <= LIMIT


def seam_nf(code, N, H, direction, most=1024):
    """The largest nf that a route before the wide-nf one takes at N atoms
    and width H (``parent_takes`` is monotone in nf)."""
    nf = 0
    while nf < most and parent_takes(code, N, nf + 1, H, direction):
        nf += 1
    return nf


# the column-chunked kernels past H = 256 (csrc/egcl_allpairs_xwide.cu).
# K2 p and float32 (egcl_xwide_kernel): two steps of staged operands (bf16:
# a [64, 64] activation chunk and a [64, 64] weight chunk a step,
# EngBf::kStageBytes; float32: egcl_wide_nf.cuh's Stage, two chunks of 16
# k x 64 of each operand) and the tile's rows (Rows: cd and dcd [64][3],
# five row vectors, ri and rj, the force sums [8][3]). bf16 K1 and K2 (the
# ring kernels, RingBf): XWIDE_RING_STAGES stages of a 64 x 128 weight
# chunk and two [64, 64] activation chunks (one a consumer warpgroup), the
# two consumers' Rows, the item's force sums [8][3] and the mbarriers
# (full and empty a stage, ready a consumer). Plus 1024 to align the base:
# no term grows with H.
XWIDE_STAGE = {1: 4 * 2 * TILE * 64, 0: 2 * 2 * 16 * 64 * 4}
XWIDE_ROWS = 4 * (2 * TILE * 3 + 5 * TILE + 2 * TILE + 8 * 3)
XWIDE_RING_STAGES = 6
XWIDE_RING = (XWIDE_RING_STAGES * 4 * 2 * TILE * 64 + 2 * XWIDE_ROWS
              + 4 * 8 * 3 + 8 * (2 * XWIDE_RING_STAGES + 2))
XWIDE_SLICE_LIMIT = 1 << 30      # bytes of one K2 p slice at most


def xwide_on_ring(code, kind):
    """Whether a launch of the dtype code and kind runs on the ring
    kernels (bf16 K1 and K2)."""
    return code == 1 and kind in (KIND["fwd"], KIND["bwd"])


def xwide_tiles(code, kind):
    """``egcl_xwide_tiles``: the [64, H] scratch tiles a block (the ring
    kernels' two consumers five each, else five); -1 for another code or
    kind."""
    if code not in XWIDE_STAGE or kind not in KIND.values():
        return -1
    return 10 if xwide_on_ring(code, kind) else 5


def xwide_slice_bytes(H):
    """Bytes of one K2 p slice at width H: PartLayout(0, H).P floats (dW2,
    dW3, then dw1r, db1, db2, db3, dw4; rounded up to 8)."""
    return 4 * ((2 * H * H + 5 * H + 7) // 8 * 8)


def xwide_max_width():
    """kMaxH: the widest multiple of 64 whose K2 p slice stays within
    XWIDE_SLICE_LIMIT."""
    H = 64
    while xwide_slice_bytes(H + 64) <= XWIDE_SLICE_LIMIT:
        H += 64
    return H


def xwide_bytes(code, H, kind):
    """``egcl_xwide_smem_bytes`` of egcl_allpairs_xwide.cu: -1 for sizes
    the kernels do not take, else the same at every H."""
    if (kind not in KIND.values() or code not in XWIDE_STAGE or H < 64
            or H % 64 or H > xwide_max_width()):
        return -1
    if xwide_on_ring(code, kind):
        return 1024 + XWIDE_RING
    return 1024 + XWIDE_STAGE[code] + XWIDE_ROWS


# the gathered-edge K5/K6 of csrc/edge_pipeline_xwide.cu (past H = 256, and
# where a route of 64 .. 256 does not hold C): the engines' staged operands
# (XWIDE_STAGE) and the tile's rows (Rows: cd [64][3], em, gate, dg and the
# rows' atoms), plus 1024 to align the base: no term grows with H or C
EDGE_XWIDE_ROWS = 4 * (TILE * 3 + 3 * TILE) + 4 * TILE


def edge_xwide_bytes(code, C, H, bwd):
    """``edge_xwide_smem_bytes`` of edge_pipeline_xwide.cu: -1 for sizes
    the kernels do not take, else the same at every C and H."""
    if (bwd not in (0, 1) or code not in XWIDE_STAGE or C < 1 or H < 64
            or H % 64 or H > xwide_max_width()):
        return -1
    return 1024 + XWIDE_STAGE[code] + EDGE_XWIDE_ROWS
