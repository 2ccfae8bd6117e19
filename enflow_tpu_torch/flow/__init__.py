"""Port of ``enflow_tpu/flow``: the invertible EGCL flow and its NLL."""

from .integrators import (FlowConfig, init_flow, forward, reverse,
                          forward_core, reverse_core)

__all__ = ["FlowConfig", "init_flow", "forward", "reverse", "forward_core",
           "reverse_core"]
