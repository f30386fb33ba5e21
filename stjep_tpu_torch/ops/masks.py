"""Masks and sinusoidal position signals (port of stjep_tpu/ops/masks.py).

Masks use True = attend, False = blocked, combined by logical AND
(ref: modules/layers.py:260-309).
"""

from __future__ import annotations

import numpy as np
import torch

from stjep_tpu_torch.config import PAD


def round_up8(x):
    """`x + 8 - x % 8`: the reference's length bump, which maps 8 -> 16
    (ref: models/Enc.py:142). Works on ints and integer tensors."""
    return x + 8 - x % 8


def bucket_length(n: int, bucket: int = 256) -> int:
    """Round n up to a multiple of `bucket`: the acoustic time axis of a
    train batch is padded to it, so batches of nearby lengths share one
    shape (stjep_tpu/ops/masks.py `bucket_length`)."""
    return ((int(n) + bucket - 1) // bucket) * bucket


def pad_mask(seq: torch.Tensor) -> torch.Tensor:
    """[b, len] ids -> [b, 1, len] bool; True where not PAD."""
    return (seq != PAD)[:, None, :]


def subsequent_mask(max_length: int, device=None) -> torch.Tensor:
    """[1, L, L] lower-triangular bool causal mask."""
    return torch.tril(torch.ones((1, max_length, max_length), dtype=torch.bool,
                                 device=device))


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[b] lengths -> [b, 1, max_len] bool; True inside the valid region."""
    ar = torch.arange(max_len, device=lengths.device)[None, :]
    return (ar < lengths[:, None])[:, None, :]


_SIGNALS: dict = {}


def position_signal(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """[1, max_len, d_model] sinusoidal signal: sin in even features, cos in
    odd ones, torch's half-table layout; with odd d_model the cos half is
    one column narrower (ref: modules/layers.py:293-309). Built in float32
    numpy exactly as the JAX package builds it, so both tables are equal.
    Each (max_len, d_model, device) table is built once and kept: a train
    or decode step reads it with no host-to-device copy, and the first copy
    to a card is a pinned, non-blocking one, so no call waits for the
    device. Callers must not write into the returned tensor."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    key = (max_len, d_model, str(dev))
    if key not in _SIGNALS:
        pe = np.zeros((max_len, d_model), dtype=np.float32)
        position = np.arange(0, max_len, dtype=np.float32)[:, None]
        div_term = np.exp(
            np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model)
        )
        pe[:, 0::2] = np.sin(position * div_term)
        pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
        table = torch.from_numpy(pe)[None, :, :]
        if dev.type == "cuda":
            table = table.pin_memory().to(dev, non_blocking=True)
        _SIGNALS[key] = table
    return _SIGNALS[key]
