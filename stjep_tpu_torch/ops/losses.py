"""Masked NLL and its normaliser (port of stjep_tpu/ops/losses.py, the two
functions the train step reads)."""

from __future__ import annotations

from typing import Tuple

import torch


def nll_loss_masked(logps: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logps [N, V], targets [N], mask [N] bool (True = counted) ->
    (summed NLL over the masked rows, number of masked rows)
    (ref: modules/loss.py:130-132, 82-83)."""
    picked = logps.gather(1, targets.long()[:, None])[:, 0]
    m = mask.to(logps.dtype)
    return -(picked * m).sum(), m.sum()


def normalise(sum_loss: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """Divide the accumulated loss by its norm term, at least 1
    (ref: modules/loss.py:82-83)."""
    return sum_loss / (1.0 * torch.clamp(norm, min=1.0))
