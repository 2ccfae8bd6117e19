"""CLI entry point: ``python -m enflow_tpu_torch <config.yaml> [--device D]``.

Mirror of ``enflow_tpu/__main__.py``. Runs on the CUDA card unless
``--device cpu`` is given.
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
    args = ap.parse_args(argv)
    Main(device=args.device)(args.config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
