"""Port of ``enflow_tpu/flow``: the invertible EGCL flow."""

from .integrators import FlowConfig, init_flow, forward_core, reverse_core

__all__ = ["FlowConfig", "init_flow", "forward_core", "reverse_core"]
