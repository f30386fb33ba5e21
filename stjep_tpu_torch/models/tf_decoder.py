"""Transformer decoder, standard type (port of
stjep_tpu/models/tf_decoder.py).

`tf_decoder_forward` is the full-sequence (teacher-forced) decoder of
training, in plain PyTorch as the JAX package leaves it to XLA, with
dropout as the encoder's. `tf_decoder_init_cache_chain` and
`tf_decoder_chain_step` are the KV-cached decode position of the beam,
through K3 (`ops/decode_flash.py`). The final LayerNorm uses torch's
default eps 1e-5, unlike the encoder's 1e-6 (ref: TFDec.py:58).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.ops.attention import linear
from stjep_tpu_torch.ops.decode_flash import (
    BLOCK,
    CROSS_BLOCK,
    decode_chain_step_flash,
    pad_len,
    stack_decoder_layers,
)
from stjep_tpu_torch.ops.masks import position_signal
from stjep_tpu_torch.ops.transformer import (
    decoder_layer,
    decoder_layer_init,
    layer_norm,
    layer_norm_init,
    split,
)
from stjep_tpu_torch.models.tf_encoder import check_standard

UPPERBOUND_SEQ_LEN = 500  # ref: TFDec.py:35


class TFDecCache(NamedTuple):
    """Stacked decode caches: self K/V [nl, group, B, Lpad, D] (zeros until
    written, never reordered) and memory K/V [nl, B, Lk_pad, D]."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    mem_k: torch.Tensor
    mem_v: torch.Tensor


def tf_decoder_init(generator: torch.Generator, cfg: ModelConfig,
                    device=None) -> Dict:
    check_standard(cfg)
    return {
        "layers": [decoder_layer_init(generator, cfg.dim_model, cfg.num_heads,
                                      cfg.dim_feedforward, device)
                   for _ in range(cfg.dec_layers)],
        "norm": layer_norm_init(cfg.dim_model, device),
    }


def tf_decoder_forward(params: Dict, cfg: ModelConfig, tgt: torch.Tensor,
                       memory: torch.Tensor,
                       tgt_mask: Optional[torch.Tensor] = None,
                       src_mask: Optional[torch.Tensor] = None,
                       max_time: int = UPPERBOUND_SEQ_LEN,
                       generator: Optional[torch.Generator] = None,
                       is_training: bool = False) -> torch.Tensor:
    """tgt [B, L, D] embedded target, memory [B, Lk, D], tgt_mask [B, L, L]
    and src_mask [B, 1, Lk] (0 = blocked) -> out [B, L, D]."""
    check_standard(cfg, is_training)
    L = tgt.shape[1]
    x = tgt + position_signal(max(max_time, L), cfg.dim_model, tgt.device)[:, :L]
    for lp in params["layers"]:
        generator, k = split(generator)
        x = decoder_layer(lp, x, memory, cfg.num_heads, self_mask=tgt_mask,
                          cross_mask=src_mask, generator=k,
                          dropout_rate=cfg.dropout, training=is_training)
    return layer_norm(params["norm"], x, eps=1e-5)  # torch default eps, ref: TFDec.py:58


def tf_decoder_init_cache_chain(params: Dict, cfg: ModelConfig,
                                memory: torch.Tensor, max_len: int,
                                group: int) -> TFDecCache:
    """Zero self caches padded to pad_len(max_len, BLOCK), and the memory
    K/V projected once (memory zero-padded to pad_len(Lk, CROSS_BLOCK);
    padded rows project to 0 and are masked at attention time)."""
    B, Lk, D = memory.shape
    mem = F.pad(memory, (0, 0, 0, pad_len(Lk, CROSS_BLOCK) - Lk))
    layers = params["layers"]
    mem_k = torch.stack([linear(lp["encdec_attn"]["w_ks"], mem) for lp in layers])
    mem_v = torch.stack([linear(lp["encdec_attn"]["w_vs"], mem) for lp in layers])
    shape = (len(layers), group, B, pad_len(max_len, BLOCK), D)
    return TFDecCache(
        self_k=torch.zeros(shape, device=memory.device, dtype=memory.dtype),
        self_v=torch.zeros(shape, device=memory.device, dtype=memory.dtype),
        mem_k=mem_k.contiguous(), mem_v=mem_v.contiguous())


def tf_decoder_chain_step(params: Dict, out_params: Dict, cfg: ModelConfig,
                          x_new: torch.Tensor, cache: TFDecCache, pos: int,
                          anc: torch.Tensor, group: int,
                          mem_mask_pad: torch.Tensor, self_mask_k: torch.Tensor,
                          topk: int, max_time: int = UPPERBOUND_SEQ_LEN):
    """Decode position `pos` for x_new [B*K, D] (the embedded token): adds
    the time signal and runs all layers and the head through K3. Returns
    (scores [B*K, topk], ids [B*K, topk]); the caches update in place."""
    check_standard(cfg)
    x = x_new + position_signal(max_time, cfg.dim_model, x_new.device)[0, pos]
    return decode_chain_step_flash(
        stack_decoder_layers(params), params["norm"], out_params, x,
        cache.self_k, cache.self_v, cache.mem_k, cache.mem_v, pos,
        cfg.num_heads, anc, group, mem_mask_pad, self_mask_k, topk)
