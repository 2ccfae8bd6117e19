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
