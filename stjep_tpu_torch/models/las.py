"""LAS = pyramidal encoder + attention decoder (port of
stjep_tpu/models/las.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.models.las_decoder import las_decoder_forward, las_decoder_init
from stjep_tpu_torch.models.las_encoder import las_encoder_forward, las_encoder_init
from stjep_tpu_torch.ops.transformer import split


def las_init(generator: torch.Generator, cfg: ModelConfig, device=None,
             dtype=torch.float32) -> Dict:
    return {"encoder": las_encoder_init(generator, cfg, device, dtype),
            "decoder": las_decoder_init(generator, cfg, device, dtype)}


def las_forward(params: Dict, cfg: ModelConfig, acous_feats: torch.Tensor,
                acous_lens: Optional[torch.Tensor] = None,
                max_seq_len: Optional[int] = None,
                tgt: Optional[torch.Tensor] = None,
                use_teacher_forcing: bool = False,
                generator: Optional[torch.Generator] = None,
                is_training: bool = False,
                ref_tokens: Optional[torch.Tensor] = None,
                teacher_forcing_ratio: Optional[float] = None,
                flash_ok: bool = True, lm_fuse=None, want_logps: bool = True,
                dense_logps: bool = False):
    """(sequence_embs, logps, symbols, lengths): see las_decoder_forward
    (lm_fuse: the n-gram LM fuser of the decode, ref: models/Las.py:91-123)."""
    g_enc, g_dec = split(generator)
    acous_outputs, _ = las_encoder_forward(params["encoder"], cfg, acous_feats,
                                           acous_lens, generator=g_enc,
                                           is_training=is_training)
    return las_decoder_forward(params["decoder"], cfg, acous_outputs,
                               acous_lens=acous_lens, max_seq_len=max_seq_len,
                               tgt=tgt, use_teacher_forcing=use_teacher_forcing,
                               generator=g_dec, is_training=is_training,
                               ref_tokens=ref_tokens,
                               teacher_forcing_ratio=teacher_forcing_ratio,
                               flash_ok=flash_ok, lm_fuse=lm_fuse, want_logps=want_logps,
                               dense_logps=dense_logps)
