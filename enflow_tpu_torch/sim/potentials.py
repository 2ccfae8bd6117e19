"""Pairwise potentials, the port of ``enflow_tpu/sim/potentials.py``:
``lj_energy`` (the sampler targets) and ``softened_lj_energy`` (the MD
potential of the simulated datasets)."""

import torch

from ..ops.pair_energy import pair_energy, pair_energy_and_grad


def lj_energy(pos: torch.Tensor, mask=None, epsilon: float = 1.0,
              sigma: float = 1.0) -> torch.Tensor:
    """Plain LJ cluster energy in reduced units, batched over leading axes:
    ``pos [..., N, 3] -> [...]``."""
    n = pos.shape[-2]
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    valid = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=pos.device), diagonal=1)
    if mask is not None:
        valid = valid & mask[..., :, None] & mask[..., None, :]
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    inv2 = torch.where(valid, (sigma * sigma) / torch.where(valid, d2, one),
                       zero)
    inv6 = inv2 * inv2 * inv2
    e = 4.0 * epsilon * (inv6 * inv6 - inv6)
    return torch.where(valid, e, zero).sum(dim=(-1, -2))


def _batch(pos, box, mask):
    n = pos.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=pos.device)
    box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    return pos[None], mask[None].to(pos.dtype), box.reshape(1, 3)


def softened_lj_energy(pos, box, softening, cutoff, mask=None):
    """Softened LJ energy ``4((s+r)^-12 - (s+r)^-6)`` of one molecule
    ``pos [N,3]`` with min-image PBC in ``box [3]`` and a radial cutoff
    (reduced units), differentiable in ``pos``. It is the pair-energy
    kernel's form ``r`` (``ops/pair_energy.py``) with its ``coincident``
    flag: on the card it launches that kernel, on the CPU it runs its
    plain version. At softening > 0 a pair of coincident atoms counts at
    ``4(s^-12 - s^-6)``, as in the JAX package's dense form; its force is
    0, where ``jax.grad`` of the dense form gives NaN (through
    ``sqrt(0)``). At softening 0 such a pair is left out (the dense form
    gives ``inf - inf = NaN`` there)."""
    p, m, b = _batch(pos, box, mask)
    return pair_energy(p, m, b, "r", softening, float(cutoff),
                       coincident=True)[0]


def softened_lj_energy_grad(pos, box, softening, cutoff, mask=None):
    """``(E, dE/dpos [N,3])`` of :func:`softened_lj_energy` from the
    kernel's one pass (no autograd): the MD force field."""
    p, m, b = _batch(pos, box, mask)
    e, g = pair_energy_and_grad(p, m, b, "r", float(softening),
                                float(cutoff), coincident=True)
    return e[0], g[0]
