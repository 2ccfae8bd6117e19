"""ArgMax dequantizer parameters, the port of ``enflow_tpu/nn/argmax.py``.

Only ``init_argmax`` is ported: it supplies the parameter layout, so a
checkpoint's leaf count matches ``init_flow``. The dequantizer's forward
and reverse come with NLL training (ROADMAP queue A item 5).
"""

import torch

from .. import resolve_device
from .mlp import init_mlp


def init_argmax(gen: torch.Generator, node_nf: int, hidden_nf: int,
                dtype=torch.float32, device=None):
    # network: Linear(nf->hidden), SiLU, Linear(hidden->2nf)
    return {"network": init_mlp(gen, [node_nf, hidden_nf, 2 * node_nf],
                                dtype, resolve_device(device))}
