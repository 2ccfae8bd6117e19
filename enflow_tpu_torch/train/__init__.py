"""Port of ``enflow_tpu/train``."""
