"""Port of ``enflow_tpu/sample``: flow-proposal SMC/AIS, per-chain
HMC/MALA/NUTS, REMC + MBAR, TI, and the force-field targets."""

from . import targets
from .mcmc import batched_value_and_grad, tempered_hmc_kernel_batched
from .smc import (SMCResult, ais, ess_from_log_weights, smc, smc_segments,
                  systematic_resample)

__all__ = ["targets", "batched_value_and_grad", "tempered_hmc_kernel_batched",
           "SMCResult", "ais", "ess_from_log_weights", "smc", "smc_segments",
           "systematic_resample"]
