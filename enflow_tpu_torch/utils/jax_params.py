"""The bridge that carries weights from the JAX package to the port.

A JAX parameter pytree is nested dicts and lists of arrays; the port keeps
the same layout with torch tensors, so conversion is a leafwise copy.
Checkpoints store leaves positionally in JAX's flatten order, which
``tree_flatten`` reproduces without JAX: dict keys sorted, list entries by
index (an EGCL flattens as ``coord_nn, edge_nn, node_nn, vel_scaling_nn``;
a flow as ``dequant, networks``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def tree_flatten(tree):
    """``(leaves, structure)`` in JAX's flatten order."""
    if isinstance(tree, dict):
        leaves, struct = [], {}
        for k in sorted(tree):
            sub, struct[k] = tree_flatten(tree[k])
            leaves += sub
        return leaves, struct
    if isinstance(tree, (list, tuple)):
        leaves, struct = [], []
        for v in tree:
            sub, s = tree_flatten(v)
            leaves += sub
            struct.append(s)
        return leaves, struct
    return [tree], None


def tree_unflatten(struct, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return next(it)

    out = build(struct)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def from_jax_params(tree, dtype: torch.dtype | None = None, device=None):
    """Turn a JAX parameter pytree (nested dicts/lists of numpy or JAX
    arrays, converted with ``np.asarray``) into the port's parameters.
    ``dtype`` defaults to each array's own; ``device`` to ``cuda``."""
    device = resolve_device(device)
    leaves, struct = tree_flatten(tree)
    out = []
    for a in leaves:
        t = torch.from_numpy(np.array(a, copy=True))
        out.append(t.to(device=device, dtype=dtype or t.dtype))
    return tree_unflatten(struct, out)
