"""LAS = pyramidal encoder + attention decoder, eval only (port of
stjep_tpu/models/las.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.models.las_decoder import las_decoder_forward, las_decoder_init
from stjep_tpu_torch.models.las_encoder import las_encoder_forward, las_encoder_init


def las_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    return {"encoder": las_encoder_init(generator, cfg, device),
            "decoder": las_decoder_init(generator, cfg, device)}


def las_forward(params: Dict, cfg: ModelConfig, acous_feats: torch.Tensor,
                acous_lens: Optional[torch.Tensor] = None,
                max_seq_len: Optional[int] = None):
    """Free-running (sequence_embs, None, symbols, lengths)."""
    acous_outputs, _ = las_encoder_forward(params["encoder"], cfg, acous_feats,
                                           acous_lens)
    return las_decoder_forward(params["decoder"], cfg, acous_outputs,
                               acous_lens=acous_lens, max_seq_len=max_seq_len)
