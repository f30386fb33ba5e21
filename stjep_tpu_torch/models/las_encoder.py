"""Pyramidal BiLSTM acoustic encoder (port of
stjep_tpu/models/las_encoder.py).

4 bidirectional LSTM layers; between layers adjacent frame pairs are merged
by reshape, halving time (8x in all). Lengths are `round_up8` (capped at T)
and then halved per layer. Training adds SpecAugment before the pyramid
and dropout after each layer (ref: Enc.py:87-117,146-217).

Routes: with `is_training`, or whenever autograd records through the
features or a weight, each layer goes through K8
(`bilstm_pallas_trainable`), which has a backward; otherwise through K1
(`bilstm_pallas`), whose CUDA route has none. The JAX package takes its
trainable kernel with `is_training` and differentiates K1 by a
recomputing VJP otherwise; the port takes K8 for both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch.bridge import leaves
from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.ops.lstm import bilstm_init
from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas
from stjep_tpu_torch.ops.lstm_pallas_bwd import bilstm_pallas_trainable
from stjep_tpu_torch.ops.masks import round_up8
from stjep_tpu_torch.ops.transformer import dropout, split


def las_encoder_init(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> Dict:
    params: Dict = {}
    in_dim = cfg.acous_dim
    for i in range(cfg.num_pyramid_layers):
        params[f"acous_enc_l{i + 1}"] = bilstm_init(
            generator, in_dim, cfg.acous_hidden_size, device)
        in_dim = 4 * cfg.acous_hidden_size  # concat of adjacent 2H frames
    return params


def spec_augment(generator: torch.Generator, acous_feats: torch.Tensor) -> torch.Tensor:
    """SpecAugment with the reference's bounds (ref: Enc.py:99-117): two
    repeats, each zeroing time steps [t0, t0 + t) and channels [f0, f0 + f)
    for the whole batch, t in [0, min(40, 0.2 T)] and f in [0, 7] (both
    inclusive, as Python's random.randint). The bounds are drawn as Python
    ints from the host generator, so nothing waits for the device."""
    _, T, C = acous_feats.shape
    const_t, const_f = int(min(40, 0.2 * T)), 7

    def randint(g, high):  # uniform in [0, high]
        return int(torch.randint(0, high + 1, (1,), generator=g))

    time_idx = torch.arange(T, device=acous_feats.device)
    chan_idx = torch.arange(C, device=acous_feats.device)
    for g in split(generator, 2):  # REPEAT = 2
        t, f = randint(g, const_t), randint(g, const_f)
        t0, f0 = randint(g, max(T - t - 1, 0)), randint(g, max(C - f - 1, 0))
        tmask = (time_idx >= t0) & (time_idx < t0 + t)
        fmask = (chan_idx >= f0) & (chan_idx < f0 + f)
        keep = ~tmask[None, :, None] & ~fmask[None, None, :]
        acous_feats = acous_feats * keep.to(acous_feats.dtype)
    return acous_feats


def las_encoder_forward(params: Dict, cfg: ModelConfig,
                        acous_feats: torch.Tensor,
                        acous_lens: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        is_training: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acous_outputs [B, T/8, 2H], lens [B])."""
    B, T, _ = acous_feats.shape
    if T % 8:
        raise ValueError("acoustic frames must be padded to a multiple of 8")
    if is_training and cfg.spec_aug:
        generator, k = split(generator)
        acous_feats = spec_augment(k, acous_feats)
    if acous_lens is None:
        lens = torch.full((B,), T, dtype=torch.int64, device=acous_feats.device)
    else:
        lens = torch.clamp(round_up8(acous_lens.long()), max=T)
    records = torch.is_grad_enabled() and any(
        t.requires_grad for t in (acous_feats, *leaves(params)))
    layer = bilstm_pallas_trainable if is_training or records else bilstm_pallas
    x = acous_feats
    n = cfg.num_pyramid_layers
    for i in range(n):
        p = params[f"acous_enc_l{i + 1}"]
        out = layer(p["fwd"], p["bwd"], x, lens)
        if is_training and cfg.dropout > 0.0:
            generator, k = split(generator)
            out = dropout(k, out, cfg.dropout, True)
        if i < n - 1:
            b, t, d = out.shape
            x = out.reshape(b, t // 2, 2 * d)
            lens = lens // 2
        else:
            x = out
    return x, lens
