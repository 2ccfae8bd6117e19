"""Port of ``enflow_tpu/sim``."""
