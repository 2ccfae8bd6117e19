"""Port of ``enflow_tpu/sim``."""
from .analysis import radial_distribution  # noqa: F401
