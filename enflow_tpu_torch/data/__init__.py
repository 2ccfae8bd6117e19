"""Port of ``enflow_tpu/data``."""
