"""Self-describing ``.npz`` checkpoints in the layout of
``enflow_tpu/train/checkpoint.py``, so that each package resumes the
other's.

Each named tree's leaves are stored positionally (``params_00000`` ...) in
JAX's flatten order (``utils/jax_params.py`` reproduces it), plus a JSON
``hparams`` entry. Loading unflattens into a freshly initialized template
and checks the leaf count and every shape; no pickled code is executed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.jax_params import tree_flatten, tree_unflatten


def save_checkpoint(path, trees: dict, hparams: dict):
    """Write the named trees' leaves and ``hparams``, atomically."""
    payload = {}
    for name, tree in trees.items():
        leaves, _ = tree_flatten(tree)
        for i, x in enumerate(leaves):
            t = x.detach().cpu()
            payload[f"{name}_{i:05d}"] = (
                t.float() if t.dtype == torch.bfloat16 else t).numpy()
    payload["hparams"] = np.frombuffer(json.dumps(hparams).encode(),
                                       dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def has_tree(path, name: str) -> bool:
    """Whether the checkpoint stores any leaves under ``name``."""
    with np.load(path) as z:
        return any(k.startswith(name + "_") for k in z.files)


def load_hparams(path) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["hparams"]).decode())


def load_checkpoint(path, templates: dict):
    """Load the named trees in ``templates`` (the port's freshly initialized
    parameter trees); each leaf takes its template's dtype and device.
    Returns ``(trees, hparams)``; raises on a leaf-count or shape
    mismatch."""
    out = {}
    with np.load(path) as z:
        hparams = json.loads(bytes(z["hparams"]).decode())
        for name, template in templates.items():
            leaves, struct = tree_flatten(template)
            keys = sorted(k for k in z.files if k.startswith(name + "_"))
            if len(keys) != len(leaves):
                raise ValueError(
                    f"checkpoint {path} tree '{name}' has {len(keys)} leaves "
                    f"but the model expects {len(leaves)} — architecture "
                    f"mismatch")
            new = []
            for key, old in zip(keys, leaves):
                arr = z[key]
                if tuple(arr.shape) != tuple(old.shape):
                    raise ValueError(
                        f"checkpoint leaf {key} shape {arr.shape} != "
                        f"expected {tuple(old.shape)}")
                new.append(torch.from_numpy(np.array(arr)).to(
                    dtype=old.dtype, device=old.device))
            out[name] = tree_unflatten(struct, new)
    return out, hparams
