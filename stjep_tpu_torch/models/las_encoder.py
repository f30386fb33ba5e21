"""Pyramidal BiLSTM acoustic encoder, eval only (port of
stjep_tpu/models/las_encoder.py).

4 bidirectional LSTM layers; between layers adjacent frame pairs are merged
by reshape, halving time (8x in all). Lengths are `round_up8` (capped at T)
and then halved per layer. SpecAugment and dropout (training) are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.ops.lstm import bilstm_init
from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas
from stjep_tpu_torch.ops.masks import round_up8


def las_encoder_init(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> Dict:
    params: Dict = {}
    in_dim = cfg.acous_dim
    for i in range(cfg.num_pyramid_layers):
        params[f"acous_enc_l{i + 1}"] = bilstm_init(
            generator, in_dim, cfg.acous_hidden_size, device)
        in_dim = 4 * cfg.acous_hidden_size  # concat of adjacent 2H frames
    return params


def las_encoder_forward(params: Dict, cfg: ModelConfig,
                        acous_feats: torch.Tensor,
                        acous_lens: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (acous_outputs [B, T/8, 2H], lens [B])."""
    B, T, _ = acous_feats.shape
    if T % 8:
        raise ValueError("acoustic frames must be padded to a multiple of 8")
    if acous_lens is None:
        lens = torch.full((B,), T, dtype=torch.int64, device=acous_feats.device)
    else:
        lens = torch.clamp(round_up8(acous_lens.long()), max=T)
    x = acous_feats
    n = cfg.num_pyramid_layers
    for i in range(n):
        p = params[f"acous_enc_l{i + 1}"]
        out = bilstm_pallas(p["fwd"], p["bwd"], x, lens)
        if i < n - 1:
            b, t, d = out.shape
            x = out.reshape(b, t // 2, 2 * d)
            lens = lens // 2
        else:
            x = out
    return x, lens
