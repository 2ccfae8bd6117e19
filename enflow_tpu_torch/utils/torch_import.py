"""Import a reference (torch) checkpoint into the port's ``.npz``, the
port of ``enflow_tpu/utils/torch_import.py``.

The reference saves one ``torch.save`` dict per epoch: the
``model_state_dict`` and the architecture hyperparameters (epoch, node_nf,
hidden_nf, softening, lj_kBT, integrator, n_iter, dt). This module turns
that file into the self-describing checkpoint of ``train/checkpoint.py``,
holding the same keys and the same bytes as the JAX module writes for the
same file, so that a trained reference model trains on, generates or
samples in the port (and in the JAX package).

State-dict keys read:

- ``networks.{k}.edge_nn.{0,2}.{weight,bias}``
- ``networks.{k}.node_nn.{0,2}.{weight,bias}``
- ``networks.{k}.coord_nn.0.{weight,bias}``, ``networks.{k}.coord_nn.2.weight``
- ``networks.{k}.vel_scaling_nn.{0,2}.{weight,bias}``
- ``networks.{k}.att_nn.0.{weight,bias}`` (optional)
- ``dequantize.network.{0,2}.{weight,bias}`` (ArgMax)

torch ``nn.Linear`` stores ``weight [out, in]``; the parameter tree
stores ``w [in, out]``. The weights are transposed in numpy into the JAX
package's layout, and that tree goes through the one conversion the port
has (``jax_params.from_jax_params``) onto the device, so the port keeps a
single parameter layout. No optimizer state is imported: the driver starts
a fresh Adam when a checkpoint has no ``opt_state``.

CLI::

    python -m enflow_tpu_torch.utils.torch_import model.cpt model.npz [float32|float64]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .jax_params import from_jax_params, tree_flatten, tree_unflatten


def _w(sd, key):
    """A torch Linear weight, transposed to ``[in, out]``."""
    return np.asarray(sd[key].detach().cpu().numpy()).T


def _b(sd, key):
    return np.asarray(sd[key].detach().cpu().numpy())


def _linear(sd, prefix, bias=True):
    layer = {"w": _w(sd, prefix + ".weight")}
    if bias:
        layer["b"] = _b(sd, prefix + ".bias")
    return layer


def convert_state_dict(sd, num_networks: int):
    """A reference ``model_state_dict`` -> the flow's parameter tree in the
    JAX package's layout (numpy leaves): the per-step EGCLs stacked on a
    leading ``[num_networks]`` axis, and the ArgMax dequantizer."""
    nets = []
    for k in range(num_networks):
        p = f"networks.{k}."
        net = {
            "edge_nn": [_linear(sd, p + "edge_nn.0"),
                        _linear(sd, p + "edge_nn.2")],
            "node_nn": [_linear(sd, p + "node_nn.0"),
                        _linear(sd, p + "node_nn.2")],
            "coord_nn": [_linear(sd, p + "coord_nn.0"),
                         _linear(sd, p + "coord_nn.2", bias=False)],
            "vel_scaling_nn": [_linear(sd, p + "vel_scaling_nn.0"),
                               _linear(sd, p + "vel_scaling_nn.2")],
        }
        if p + "att_nn.0.weight" in sd:
            net["att_nn"] = _linear(sd, p + "att_nn.0")
        nets.append(net)
    flat = [tree_flatten(n) for n in nets]
    struct = flat[0][1]
    if any(s != struct for _, s in flat):
        raise ValueError("the networks of the state dict differ in their "
                         "layers (att_nn in some only)")
    networks = tree_unflatten(struct, [np.stack(leaves) for leaves in
                                       zip(*(f[0] for f in flat))])
    dequant = {"network": [_linear(sd, "dequantize.network.0"),
                           _linear(sd, "dequantize.network.2")]}
    return {"networks": networks, "dequant": dequant}


def load_reference_checkpoint(path):
    """Read a reference ``model.cpt``: ``(params, hparams)``, ``params`` the
    JAX-layout tree of numpy float64 leaves (the reference model is
    float64) and ``hparams`` the keys the driver's checkpoints carry. The
    network count comes from the state dict (its ``networks.<k>``
    prefixes, which must be contiguous) and must be what the integrator
    needs (``n_iter``, or ``n_iter + 1`` for ``vv``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model_state_dict"]
    n_iter = int(ckpt["n_iter"])
    integrator = str(ckpt["integrator"]).lower()
    net_ids = {int(k.split(".")[1]) for k in sd
               if k.startswith("networks.")}
    if not net_ids:
        raise ValueError(f"{path}: no networks.<k>.* entries in "
                         "model_state_dict — not a reference flow checkpoint")
    num_networks = max(net_ids) + 1
    if net_ids != set(range(num_networks)):
        raise ValueError(f"{path}: non-contiguous network indices "
                         f"{sorted(net_ids)} in model_state_dict")
    expected = n_iter + 1 if integrator == "vv" else n_iter
    if num_networks != expected:
        raise ValueError(
            f"{path}: checkpoint holds {num_networks} EGCL networks but "
            f"integrator={integrator!r} with n_iter={n_iter} needs "
            f"{expected}; cannot restore this model faithfully")
    params = convert_state_dict(sd, num_networks)
    hparams = {
        "epoch": int(ckpt.get("epoch", 0)),
        "node_nf": int(ckpt["node_nf"]),
        "hidden_nf": int(ckpt["hidden_nf"]),
        "softening": float(ckpt["softening"]),
        "lj_kBT": float(ckpt["lj_kBT"]),
        "integrator": integrator,
        "dequantizer": "argmax",   # the reference's only dequantizer
        "n_iter": n_iter,
        "dt": float(ckpt["dt"]),
    }
    return params, hparams


def import_reference_checkpoint(in_path, out_path, dtype="float64",
                                device=None):
    """Convert ``in_path`` (a reference ``.cpt``) to ``out_path`` (the
    port's ``.npz``) with the leaves in ``dtype``. Returns the port's
    parameters (on ``device``: ``cuda`` unless the caller asks for the
    CPU) and the hparams. The file restores through the driver's normal
    checkpoint path and a fresh optimizer."""
    from ..train.checkpoint import save_checkpoint

    device = resolve_device(device)
    params, hparams = load_reference_checkpoint(in_path)
    leaves, struct = tree_flatten(params)
    dt = np.dtype(dtype)
    params = from_jax_params(
        tree_unflatten(struct, [x.astype(dt) for x in leaves]),
        device=device)
    save_checkpoint(out_path, {"params": params}, hparams)
    return params, hparams


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__)
        raise SystemExit(2)
    dtype = argv[2] if len(argv) == 3 else "float64"
    _, hparams = import_reference_checkpoint(argv[0], argv[1], dtype)
    print(f"imported {argv[0]} -> {argv[1]}  "
          f"(integrator={hparams['integrator']}, n_iter={hparams['n_iter']}, "
          f"hidden_nf={hparams['hidden_nf']}, node_nf={hparams['node_nf']}, "
          f"epoch={hparams['epoch']}, dtype={dtype})")


if __name__ == "__main__":
    main()
