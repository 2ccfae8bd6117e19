"""The hidden widths that the EGCL kernels (all-pairs and gathered-edge)
are built for, the zero-padding of a launch onto them, and the shared
memory a block of either may use."""

import torch

# every width a launch runs at: 64 and 128 with W2 / W3 whole in shared
# memory, 192 and 256 with them streamed through a ring of slabs; another
# H <= 256 is zero-padded up to the next of them
PADDED_H = (64, 128, 192, 256)
# shared memory a block may use on the card (kMaxSmem of the kernels)
SMEM_LIMIT = 232448


def padded_width(H: int):
    """The width a launch of hidden width ``H`` runs at: the smallest of
    ``PADDED_H`` (64, 128, 192, 256) that is at least ``H``; None past
    256."""
    return next((w for w in PADDED_H if w >= H), None)


def pad_rows(t, Hp: int):
    """``t [..., H]`` with zero columns up to ``Hp``."""
    return torch.nn.functional.pad(t, (0, Hp - t.shape[-1]))
