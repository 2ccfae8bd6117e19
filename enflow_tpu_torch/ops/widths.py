"""The hidden widths that the EGCL kernels (all-pairs and gathered-edge)
are built for, the zero-padding of a launch onto them, and the shared
memory a block of either may use."""

import math

import torch

# every width a launch up to 256 runs at: 64 and 128 with W2 / W3 whole in
# shared memory, 192 and 256 with them streamed through a ring of slabs;
# another H <= 256 is zero-padded up to the next of them, and a width past
# 256 to the next multiple of 64 (the all-pairs kernels of
# csrc/egcl_allpairs_xwide.cu take any)
PADDED_H = (64, 128, 192, 256)
# shared memory a block may use on the card (kMaxSmem of the kernels)
SMEM_LIMIT = 232448
# the widest padded H of the column-chunked kernels past 256 (kMaxH of
# csrc/egcl_allpairs_xwide.cu and csrc/edge_pipeline_xwide.cu: one block's
# f32 slice of the parameter gradients, at least 2 H^2 floats, within
# XWIDE_SLICE_BYTES), and the queue item that holds the wider ones
XWIDE_MAX_H = 11520
XWIDE_SLICE_BYTES = 1 << 30
XWIDE_ITEM = "ROADMAP queue B, B7.5: the EGCL past H = 11,520, both kernels"


def padded_width(H: int) -> int:
    """The width a launch of hidden width ``H`` runs at: the smallest of
    ``PADDED_H`` (64, 128, 192, 256) that is at least ``H``; past 256 the
    next multiple of 64 (300 -> 320)."""
    if H > PADDED_H[-1]:
        return 64 * math.ceil(H / 64)
    return next(w for w in PADDED_H if w >= H)


def pad_rows(t, Hp: int):
    """``t [..., H]`` with zero columns up to ``Hp``."""
    return torch.nn.functional.pad(t, (0, Hp - t.shape[-1]))
