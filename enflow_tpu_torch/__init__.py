"""enflow_tpu_torch — the PyTorch/CUDA port of ``enflow_tpu`` for NVIDIA Hopper.

The package mirrors ``enflow_tpu/`` module by module (same names, same
parameter layout: linear ``w`` as ``[in, out]``, per-step EGCL parameters
stacked on a leading ``[n_iter]`` axis), so a JAX parameter pytree converts
by renaming (``utils/jax_params.py``). Plain tensor code is PyTorch; each
kernel that the JAX package runs in Pallas on the TPU is a CUDA kernel
written for ``sm_90a`` (``csrc/``, built by ``ops/build.py``): the fused
all-pairs EGCL edge pipeline (``csrc/egcl_allpairs_sm90.cu`` in bf16,
``csrc/egcl_allpairs_f32.cu`` in float32, bound in
``ops/egcl_allpairs.py``), the gathered-edge pipeline and the pair
energy.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise instead of falling back.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    no card is visible — the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "enflow_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
