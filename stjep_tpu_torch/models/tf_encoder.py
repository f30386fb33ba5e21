"""Transformer text encoder, standard and universal types (port of
stjep_tpu/models/tf_encoder.py).

Standard: N independently parameterised pre-LN layers. Universal: one
shared layer applied N times, with a per-hop sinusoidal layer signal added
before every hop (ref: TFEnc.py:53-59); with `cfg.act` the shared layer
runs under ACT's halting loop instead (models/act.py), which adds the time
and layer signals itself every hop. Otherwise the time signal is added once
before the stack; the final LayerNorm uses eps 1e-6 (ref: models/TFEnc.py:61-89).
With `is_training`, dropout at cfg.dropout (and attention-probability
dropout at 0.1) draws from `generator`, split once per hop as the JAX code
splits its key. `cfg.remat` with `is_training` runs each layer under
torch.utils.checkpoint: the checkpointed function gets the hop's seed and
builds its generator itself, so the backward's recompute draws the same
dropout masks (`checkpointed`). Plain PyTorch: the JAX package runs this
stage in XLA, with no kernel of its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.models.act import ACT_NO_GRAD, act_enc_apply, act_init
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
    if is_training and uses_act(cfg):
        raise ValueError(ACT_NO_GRAD)


def uses_act(cfg: ModelConfig) -> bool:
    """ACT runs on the universal type only (ref: TFEnc.py:53-59)."""
    return bool(cfg.act) and cfg.transformer_type == "universal"


def _layer_params(params: Dict, cfg: ModelConfig, i: int) -> Dict:
    """Hop i's layer: the one shared layer of a universal transformer."""
    return params["layers"][0 if cfg.transformer_type == "universal" else i]


def checkpointed(layer, *args, generator: Optional[torch.Generator], **kw):
    """layer(*args, generator=g, **kw) under torch.utils.checkpoint, g a
    fresh generator from `generator`'s seed inside the checkpointed
    function, so the recompute of the backward replays the forward's
    dropout masks bit for bit."""
    seed = None if generator is None else generator.initial_seed()

    def run(*a):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return layer(*a, generator=g, **kw)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def tf_encoder_init(generator: torch.Generator, cfg: ModelConfig,
                    device=None, dtype=torch.float32) -> Dict:
    check_supported(cfg)
    n = 1 if cfg.transformer_type == "universal" else cfg.enc_layers
    params: Dict = {
        "layers": [encoder_layer_init(generator, cfg.dim_model, cfg.num_heads,
                                      cfg.dim_feedforward, device, dtype)
                   for _ in range(n)]}
    if uses_act(cfg):
        params["act_fn"] = act_init(generator, cfg.dim_model, device, dtype)
    params["norm"] = layer_norm_init(cfg.dim_model, device, dtype)
    return params


def tf_encoder_forward(params: Dict, cfg: ModelConfig, src: torch.Tensor,
                       src_mask: Optional[torch.Tensor] = None,
                       max_time: int = UPPERBOUND_SEQ_LEN,
                       generator: Optional[torch.Generator] = None,
                       is_training: bool = False) -> torch.Tensor:
    """src [B, L, D] embedded input, src_mask [B, 1, L] (0 = blocked) ->
    encoded [B, L, D]."""
    check_supported(cfg, is_training)
    L = src.shape[1]
    time_sig = position_signal(max(max_time, L), cfg.dim_model, src.device)
    layer_sig = position_signal(cfg.enc_layers, cfg.dim_model, src.device)
    if uses_act(cfg):
        x, _ = act_enc_apply(params["act_fn"], _layer_params(params, cfg, 0),
                                     cfg, src, src_mask, time_sig, layer_sig,
                                     cfg.act_max_hop or cfg.enc_layers)
    else:
        x = src + time_sig[:, :L].to(src.dtype)
        layer_sig = layer_sig[0].to(src.dtype)
        for hop in range(cfg.enc_layers):
            if cfg.transformer_type == "universal":
                x = x + layer_sig[hop]
            generator, k = split(generator)
            args = (_layer_params(params, cfg, hop), x, cfg.num_heads)
            kw = dict(mask=src_mask, dropout_rate=cfg.dropout, training=is_training)
            if cfg.remat and is_training:
                x = checkpointed(encoder_layer, *args, generator=k, **kw)
            else:
                x = encoder_layer(*args, generator=k, **kw)
    return layer_norm(params["norm"], x, eps=1e-6)
