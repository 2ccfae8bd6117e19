"""Ring EGCL: atom-sharded E(n)-equivariant message passing, the port of
``enflow_tpu/parallel/ring.py``.

Each shard holds a block of every molecule's atoms. The neighbour blocks
``(h, pos, mask)`` go around the ring (``axis.ring_shift``) while each
shard accumulates its atoms' message aggregate, gated-displacement sum and
neighbour count, then applies the node heads: O(N^2 / K) edge work and
``[B, N/K, N/K, H]`` edge tensors a shard. The per-block math is the plain
EGCL's ``edge_messages`` / ``node_outputs``, so the ring agrees with the
dense EGCL to round-off. The JAX package runs this branch before any
kernel route, outside any Pallas kernel; the port runs it as plain PyTorch
on every device, one ``counts.ring_calls`` a call (``axis.size`` block
evaluations).

``nbr_mode`` 'dense' is the min-image displacement and the ``r_cut`` test;
'all_pairs' has no distance test. The top-k formats are a global op over
the atom axis and do not shard this way.
"""

from __future__ import annotations

import torch

from ..nn.egcl import EGCLConfig, _cast_compute, edge_messages, node_outputs
from ..ops.build import LaunchCounts
from ..utils.helpers import min_image

counts = LaunchCounts("ring_calls")


def ring_egcl(params, cfg: EGCLConfig, h_blk, pos_blk, mask_blk, box, r_cut,
              axis, nbr_mode: str = "dense"):
    """One EGCL with atoms sharded over ``axis``: per-shard ``h_blk [B,
    n_blk, nf]``, ``pos_blk [B, n_blk, 3]``, ``mask_blk [B, n_blk]``, and
    ``box [B, 3]`` / ``r_cut [B]`` per molecule. Returns this shard's rows
    of the dense EGCL's ``(Q [B, n_blk, 1], F [B, n_blk, 3], G [B, n_blk,
    nf])``, in the input dtype (the message passing in
    ``cfg.compute_dtype`` when set)."""
    counts.ring_calls += 1
    in_dtype = h_blk.dtype
    params, h_blk = _cast_compute(params, cfg, h_blk)
    pos_blk = pos_blk.to(h_blk.dtype)
    box_b = box[:, None, None, :].to(pos_blk.dtype)
    r2_cut = (r_cut * r_cut)[:, None, None].to(pos_blk.dtype)
    n_blk = h_blk.shape[1]
    eye = torch.eye(n_blk, dtype=torch.bool, device=h_blk.device)

    def block(s, h_j, pos_j, mask_j):
        diff = min_image(pos_blk[:, :, None, :] - pos_j[:, None, :, :], box_b)
        valid = mask_blk[:, :, None] & mask_j[:, None, :]
        if nbr_mode == "dense":
            valid = valid & ((diff * diff).sum(-1) < r2_cut)
        if s == 0:          # self pairs exist only on rotation 0's diagonal
            valid = valid & ~eye
        diff = torch.where(valid[..., None], diff, torch.zeros_like(diff))
        m, trans = edge_messages(params, cfg, h_blk, h_j[:, None], diff,
                                 valid)
        return m.sum(dim=2), trans.sum(dim=2), valid.sum(dim=2,
                                                        dtype=torch.int32)

    h_j, pos_j, mask_j = h_blk, pos_blk, mask_blk
    agg = f_sum = count = None
    for s in range(axis.size):
        a, f, c = block(s, h_j, pos_j, mask_j)
        if agg is None:
            agg, f_sum, count = a, f, c
        else:
            agg, f_sum, count = agg + a, f_sum + f, count + c
        if s + 1 < axis.size:
            h_j, pos_j, mask_j = (axis.ring_shift(h_j),
                                  axis.ring_shift(pos_j),
                                  axis.ring_shift(mask_j))
    Q, F, G = node_outputs(params, cfg, h_blk, agg, f_sum, count[..., None],
                           mask_blk)
    return Q.to(in_dtype), F.to(in_dtype), G.to(in_dtype)
