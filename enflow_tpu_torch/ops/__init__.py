"""Port of ``enflow_tpu/ops``."""
