"""Port of ``enflow_tpu/utils``."""
