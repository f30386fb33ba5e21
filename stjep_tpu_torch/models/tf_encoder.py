"""Transformer text encoder, standard and universal types (port of
stjep_tpu/models/tf_encoder.py).

Standard: N independently parameterised pre-LN layers. Universal: one
shared layer applied N times, with a per-hop sinusoidal layer signal added
before every hop (ref: TFEnc.py:53-59). The time signal is added once
before the stack; the final LayerNorm uses eps 1e-6 (ref: models/TFEnc.py:61-89).
With `is_training`, dropout at cfg.dropout (and attention-probability
dropout at 0.1) draws from `generator`, split once per hop as the JAX code
splits its key. ACT and `cfg.remat` are not ported yet (remat raises:
torch.utils.checkpoint would re-run the layer and draw its dropout masks
anew). Plain PyTorch: the JAX package runs this stage in XLA, with no
kernel of its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.ops.masks import position_signal
from stjep_tpu_torch.ops.transformer import (
    encoder_layer,
    encoder_layer_init,
    layer_norm,
    layer_norm_init,
    split,
)

UPPERBOUND_SEQ_LEN = 500  # ref: TFEnc.py:35


def check_supported(cfg: ModelConfig, is_training: bool = False):
    if cfg.transformer_type not in ("standard", "universal"):
        raise ValueError(f"not implemented transformer type {cfg.transformer_type}")
    if cfg.act:
        raise NotImplementedError(
            "ACT is not ported yet (ROADMAP Queue A item 14)")
    if cfg.remat and is_training:
        raise NotImplementedError(
            "cfg.remat is not ported: torch.utils.checkpoint would re-run "
            "each layer and draw its dropout masks anew")


def _layer_params(params: Dict, cfg: ModelConfig, i: int) -> Dict:
    """Hop i's layer: the one shared layer of a universal transformer."""
    return params["layers"][0 if cfg.transformer_type == "universal" else i]


def tf_encoder_init(generator: torch.Generator, cfg: ModelConfig,
                    device=None) -> Dict:
    check_supported(cfg)
    n = 1 if cfg.transformer_type == "universal" else cfg.enc_layers
    return {
        "layers": [encoder_layer_init(generator, cfg.dim_model, cfg.num_heads,
                                      cfg.dim_feedforward, device)
                   for _ in range(n)],
        "norm": layer_norm_init(cfg.dim_model, device),
    }


def tf_encoder_forward(params: Dict, cfg: ModelConfig, src: torch.Tensor,
                       src_mask: Optional[torch.Tensor] = None,
                       max_time: int = UPPERBOUND_SEQ_LEN,
                       generator: Optional[torch.Generator] = None,
                       is_training: bool = False) -> torch.Tensor:
    """src [B, L, D] embedded input, src_mask [B, 1, L] (0 = blocked) ->
    encoded [B, L, D]."""
    check_supported(cfg, is_training)
    L = src.shape[1]
    x = src + position_signal(max(max_time, L), cfg.dim_model, src.device)[:, :L]
    layer_sig = position_signal(cfg.enc_layers, cfg.dim_model, src.device)[0]
    for hop in range(cfg.enc_layers):
        if cfg.transformer_type == "universal":
            x = x + layer_sig[hop]
        generator, k = split(generator)
        x = encoder_layer(_layer_params(params, cfg, hop), x, cfg.num_heads,
                          mask=src_mask, generator=k, dropout_rate=cfg.dropout,
                          training=is_training)
    return layer_norm(params["norm"], x, eps=1e-6)
