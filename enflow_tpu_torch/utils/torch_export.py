"""Export the port's checkpoint to the reference (torch) format, the port
of ``enflow_tpu/utils/torch_export.py``.

The inverse of :mod:`.torch_import`: the self-describing ``.npz``
(``train/checkpoint.py``) becomes the single ``torch.save`` dict that the
reference driver writes and loads, with the same keys, the transposes
undone (``w [in, out]`` -> ``weight [out, in]``) and a fresh torch-Adam
``optimizer_state_dict`` (empty ``state``, one parameter group listing the
model's tensors), which the reference loads on resume and which restarts
the moments. Coupled/drift flows (drift networks) and the Floor
dequantizer have no reference form and are refused.

CLI::

    python -m enflow_tpu_torch.utils.torch_export model.npz model.cpt [--lr 1e-3]
"""

from __future__ import annotations

import torch

from .. import resolve_device

# torch.optim.Adam's per-group hyperparameters that a fresh state dict
# must carry for Optimizer.load_state_dict and Adam.step after a restore
_ADAM_GROUP_DEFAULTS = {
    "lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
    "amsgrad": False, "maximize": False, "foreach": None,
    "capturable": False, "differentiable": False, "fused": None,
}


def _t(x):
    """A parameter-tree weight ``[in, out]`` -> a CPU float64 tensor
    ``[out, in]``."""
    return x.detach().to("cpu", torch.float64).T.contiguous()


def _v(x):
    return x.detach().to("cpu", torch.float64).clone()


def _emit_linear(sd, prefix, layer):
    sd[prefix + ".weight"] = _t(layer["w"])
    if "b" in layer:
        sd[prefix + ".bias"] = _v(layer["b"])


def params_to_state_dict(params):
    """The port's flow parameters -> the reference ``model_state_dict``
    (the per-step networks unstacked into ``networks.{k}.*``; the exact
    inverse of :func:`.torch_import.convert_state_dict`)."""
    if "pos_networks" in params:
        raise ValueError(
            "position_update='coupled'/'drift' flows have no reference-format "
            "representation (the reference flow has no drift networks, "
            "dynamics.py:12-21); export the shift-flow part is not "
            "meaningful — keep coupled checkpoints in the native npz format")
    nets = params["networks"]
    num_networks = nets["edge_nn"][0]["w"].shape[0]
    sd = {}
    for k in range(num_networks):
        p = f"networks.{k}."
        for name in ("edge_nn", "node_nn", "coord_nn", "vel_scaling_nn"):
            for i, layer in zip((0, 2), nets[name]):
                _emit_linear(sd, f"{p}{name}.{i}",
                             {n: v[k] for n, v in layer.items()})
        if "att_nn" in nets:
            _emit_linear(sd, p + "att_nn.0",
                         {n: v[k] for n, v in nets["att_nn"].items()})
    for i, layer in zip((0, 2), params["dequant"]["network"]):
        _emit_linear(sd, f"dequantize.network.{i}", layer)
    return sd


def _fresh_adam_state_dict(n_params: int, lr: float):
    group = dict(_ADAM_GROUP_DEFAULTS, lr=lr, params=list(range(n_params)))
    return {"state": {}, "param_groups": [group]}


def export_reference_checkpoint(in_path, out_path, lr: float = 1e-3,
                                device=None):
    """Convert ``in_path`` (the port's or the JAX package's ``.npz``) to
    ``out_path`` (a reference ``.cpt``); the architecture comes from the
    checkpoint's hparams. The parameters load onto ``device`` (``cuda``
    unless the caller asks for the CPU) in float64. Returns ``(state_dict,
    hparams)``."""
    from ..flow.integrators import FlowConfig, init_flow
    from ..nn.egcl import EGCLConfig
    from ..train.checkpoint import load_checkpoint, load_hparams

    device = resolve_device(device)
    hparams = load_hparams(in_path)
    if hparams.get("dequantizer", "argmax") != "argmax":
        raise ValueError(
            "the reference checkpoint format only supports the ArgMax "
            f"dequantizer (main.py:153); this checkpoint uses "
            f"{hparams.get('dequantizer')!r}")
    cfg = FlowConfig(
        n_iter=int(hparams["n_iter"]), dt=float(hparams["dt"]),
        egcl=EGCLConfig(node_nf=int(hparams["node_nf"]),
                        hidden_nf=int(hparams["hidden_nf"])),
        integrator=str(hparams.get("integrator", "lf")))
    template = init_flow(torch.Generator().manual_seed(0), cfg,
                         torch.float64, device)
    trees, _ = load_checkpoint(in_path, {"params": template})
    sd = params_to_state_dict(trees["params"])
    torch.save({
        "epoch": int(hparams.get("epoch", 0)),
        "model_state_dict": sd,
        "optimizer_state_dict": _fresh_adam_state_dict(len(sd), lr),
        "node_nf": int(hparams["node_nf"]),
        "hidden_nf": int(hparams["hidden_nf"]),
        "softening": float(hparams.get("softening", 0.0)),
        "lj_kBT": float(hparams.get("lj_kBT", 1.0)),
        "integrator": str(hparams.get("integrator", "lf")),
        "n_iter": int(hparams["n_iter"]),
        "dt": float(hparams["dt"]),
    }, out_path)
    return sd, hparams


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    lr = 1e-3
    if "--lr" in argv:
        i = argv.index("--lr")
        lr = float(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    sd, hparams = export_reference_checkpoint(argv[0], argv[1], lr=lr)
    print(f"exported {argv[0]} -> {argv[1]}  "
          f"(integrator={hparams.get('integrator', 'lf')}, "
          f"n_iter={hparams['n_iter']}, hidden_nf={hparams['hidden_nf']}, "
          f"node_nf={hparams['node_nf']}, {len(sd)} tensors)")


if __name__ == "__main__":
    main()
