"""The training optimizer: optax's ``adam`` (optionally after
``clip_by_global_norm``, with a staircase exponential schedule) on
``torch.optim.Adam``, with its state in optax's checkpoint layout. For
flow-VI a stateless first step zeroes non-finite gradients (NaN and
+-inf), as ``enflow_tpu/train/driver.py:390-406`` chains
``optax.stateless`` before the clip.

``torch.optim.Adam`` computes optax ``adam``'s update
(``lr * mu_hat / (sqrt(nu_hat) + eps)``, ``eps_root = 0``), in another
rounding order. Clipping follows optax: when the global norm is not below
``c`` every gradient becomes ``g / norm * c`` (no ``1e-6`` as in torch's
``clip_grad_norm_``); it runs on the device, with no host sync.

Checkpoint layout (``opt_state`` leaves): ``count, *mu, *nu`` in the
parameters' flatten order, and the schedule's ``count`` after them when a
schedule is on -- the leaves of ``optax.adam(lr)``, of
``chain(clip_by_global_norm, adam)``, of ``chain(stateless,
clip_by_global_norm, adam)`` and of ``adam(schedule)`` (the stateless and
clip steps hold no leaves).
"""

from __future__ import annotations

import torch


class NLLOptimizer:
    """Adam over ``leaves`` (tensors that require grad); with
    ``zero_nonfinite`` (flow-VI) non-finite gradients become 0 first. A
    leaf without a gradient counts as a zero gradient, as in optax."""

    def __init__(self, leaves, lr: float, schedule=None, grad_clip=None,
                 zero_nonfinite: bool = False):
        self.leaves = list(leaves)
        self.lr = float(lr)
        self.schedule = schedule            # (transition steps, decay rate)
        self.grad_clip = None if grad_clip is None else float(grad_clip)
        self.zero_nonfinite = zero_nonfinite
        self.adam = torch.optim.Adam(self.leaves, lr=self.lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.steps_taken = 0

    def lr_at(self, step: int) -> float:
        """The learning rate of update ``step`` (0-based):
        ``lr * gamma ** (step // transition_steps)`` with a schedule."""
        if self.schedule is None:
            return self.lr
        every, gamma = self.schedule
        return self.lr * gamma ** (step // every)

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        """Zero non-finite gradients and clip (when asked), then one Adam
        update at this step's rate."""
        grads = [p.grad for p in self.leaves if p.grad is not None]
        if self.zero_nonfinite:
            for g in grads:
                torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
        if self.grad_clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            with torch.no_grad():
                for g in grads:
                    g.copy_(torch.where(norm < self.grad_clip, g,
                                        g / norm * self.grad_clip))
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.steps_taken)
        self.adam.step()
        self.steps_taken += 1

    def state_leaves(self) -> list:
        """The state as optax's leaves (see the module docstring)."""
        count = torch.tensor(self.steps_taken, dtype=torch.int32)
        mu, nu = [], []
        for p in self.leaves:
            st = self.adam.state.get(p, {})
            mu.append(st.get("exp_avg", torch.zeros_like(p)).detach())
            nu.append(st.get("exp_avg_sq", torch.zeros_like(p)).detach())
        return [count, *mu, *nu] + ([count] if self.schedule else [])

    def load_state_leaves(self, leaves):
        """Restore from optax's leaves: ``count`` becomes Adam's ``step``,
        ``mu``/``nu`` its ``exp_avg``/``exp_avg_sq``."""
        n = len(self.leaves)
        self.steps_taken = int(leaves[0])
        for p, m, v in zip(self.leaves, leaves[1:1 + n],
                           leaves[1 + n:1 + 2 * n]):
            self.adam.state[p] = {
                "step": torch.tensor(float(self.steps_taken),
                                     dtype=torch.float32),
                "exp_avg": m.to(device=p.device, dtype=p.dtype).clone(),
                "exp_avg_sq": v.to(device=p.device, dtype=p.dtype).clone()}
