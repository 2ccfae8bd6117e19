"""CLI entry point: ``python -m enflow_tpu_torch <config.yaml> [--device D]
[--virtual-devices K]``.

Mirror of ``enflow_tpu/__main__.py``. Runs on the CUDA card unless
``--device cpu`` is given. ``--virtual-devices K`` gives one process K
virtual devices, the counterpart of XLA's forced host device count, so a
config with ``parallel.atom_axis: K`` runs on one card; several processes
(torchrun, or SLURM with ``COORDINATOR_ADDRESS``) are the devices
themselves.
"""

import argparse
import sys

from .train.driver import Main


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m enflow_tpu_torch")
    ap.add_argument("config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the plain "
                         "PyTorch path)")
    ap.add_argument("--virtual-devices", type=int, default=1, metavar="K",
                    help="devices of the in-process mesh (default 1)")
    args = ap.parse_args(argv)
    Main(device=args.device, virtual_devices=args.virtual_devices)(
        args.config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
