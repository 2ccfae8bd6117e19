"""Port of ``enflow_tpu/nn``."""
