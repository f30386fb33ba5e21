"""Optimizer: global-norm clip, Adam with torch's defaults, and the
reference LR schedule (port of stjep_tpu/train/optim.py).

The JAX package chains optax.clip_by_global_norm -> scale_by_adam(0.9,
0.999, 1e-8) -> -lr, with the LR written into the state every step. Here
the clip is written out as optax computes it (`g * max_norm / norm` only
when norm >= max_norm; torch's clip_grad_norm_ adds 1e-6 to the norm), and
Adam is `torch.optim.Adam`, the same update, which steps the parameters in
place. Freezing masks (`trainable_mask`) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from stjep_tpu_torch.bridge import leaves


def reference_lr(step, init_lr: float, peak_lr: float,
                 warmup_steps: int) -> float:
    """ref: trainer_base.py:135-154. Pure host math, called every step:
    warmup_steps <= 0 keeps init_lr; up to warmup_steps the LR moves
    linearly from init_lr to peak_lr (downward when peak < init); after it
    decays as peak * step^-0.5 * warmup^0.5."""
    if warmup_steps <= 0:
        return float(init_lr)
    step = float(step)
    if step <= warmup_steps:
        return step * (peak_lr - init_lr) / warmup_steps + init_lr
    return peak_lr * max(step, 1.0) ** -0.5 * warmup_steps ** 0.5


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    max_norm, else each t / norm * max_norm. No host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Optimizer:
    """clip -> Adam, in place on a params tree's leaves."""

    def __init__(self, max_grad_norm: float = 1.0):
        self.max_grad_norm = max_grad_norm

    def init(self, params: Dict) -> torch.optim.Adam:
        """The optimizer state: Adam over the tree's leaves, LR 0 until
        set_lr writes it."""
        return torch.optim.Adam(leaves(params), lr=0.0, betas=(0.9, 0.999),
                                eps=1e-8)

    def update(self, grads: List[torch.Tensor], opt_state: torch.optim.Adam):
        """One step from grads, in the order of bridge.leaves(params)."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        ps = opt_state.param_groups[0]["params"]
        for p, g in zip(ps, grads, strict=True):
            p.grad = g
        opt_state.step()
        for p in ps:
            p.grad = None


def make_optimizer(max_grad_norm: float = 1.0) -> Optimizer:
    """clip-by-global-norm (when max_grad_norm > 0) -> Adam (torch
    defaults); the LR lives in the state, written by set_lr."""
    return Optimizer(max_grad_norm)


def set_lr(opt_state: torch.optim.Adam, lr: float) -> torch.optim.Adam:
    """Write the learning rate for the next update (the reference writes
    param_group['lr'] every step)."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state
