"""Transformer decoder, standard and universal types (port of
stjep_tpu/models/tf_decoder.py).

`tf_decoder_forward` is the full-sequence (teacher-forced) decoder of
training, in plain PyTorch as the JAX package leaves it to XLA, with
dropout as the encoder's. The universal type shares one layer across its
hops and adds the layer signal before every hop, as the encoder does. The
KV-cached decode position of the beam and of greedy eval has two routes
over the caches of `tf_decoder_init_cache_chain`: `tf_decoder_chain_step`
runs all layers and the head through K3 (standard type only, JAX's
`chain_supported`), `tf_decoder_step_flash` one K5 per hop (either type),
before the separate head K7 (`ops/decode_flash.py`); with a model axis
`tf_decoder_step_flash` runs the tensor-parallel trio per hop over the
shards' caches (`ops/decode_flash_tp.py`). The final LayerNorm
uses torch's default eps 1e-5, unlike the encoder's 1e-6 (ref: TFDec.py:58).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.models.act import act_dec_apply, act_init
from stjep_tpu_torch.models.tf_encoder import (
    _layer_params,
    check_supported,
    checkpointed,
    uses_act,
)
from stjep_tpu_torch.ops.attention import linear
from stjep_tpu_torch.ops.decode_flash import (
    BLOCK,
    CROSS_BLOCK,
    decode_chain_step_flash,
    decoder_layer_step_flash,
    pad_len,
)
from stjep_tpu_torch.ops.decode_flash_tp import (
    ModelAxis,
    decode_head_tp,
    decoder_layer_step_flash_tp,
)
from stjep_tpu_torch.ops.masks import position_signal
from stjep_tpu_torch.ops.transformer import (
    decoder_layer,
    decoder_layer_init,
    layer_norm,
    layer_norm_init,
    split,
)

UPPERBOUND_SEQ_LEN = 500  # ref: TFDec.py:35


class TFDecCache(NamedTuple):
    """Decode caches, one per hop: self K/V [nl, group, B, Lpad, D] (zeros
    until written, never reordered) and memory K/V [nl, B, Lk_pad, D]."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    mem_k: torch.Tensor
    mem_v: torch.Tensor


def tf_decoder_init(generator: torch.Generator, cfg: ModelConfig,
                    device=None, dtype=torch.float32) -> Dict:
    check_supported(cfg)
    n = 1 if cfg.transformer_type == "universal" else cfg.dec_layers
    params: Dict = {
        "layers": [decoder_layer_init(generator, cfg.dim_model, cfg.num_heads,
                                      cfg.dim_feedforward, device, dtype)
                   for _ in range(n)]}
    if uses_act(cfg):
        params["act_fn"] = act_init(generator, cfg.dim_model, device, dtype)
    params["norm"] = layer_norm_init(cfg.dim_model, device, dtype)
    return params


def tf_decoder_forward(params: Dict, cfg: ModelConfig, tgt: torch.Tensor,
                       memory: torch.Tensor,
                       tgt_mask: Optional[torch.Tensor] = None,
                       src_mask: Optional[torch.Tensor] = None,
                       max_time: int = UPPERBOUND_SEQ_LEN,
                       generator: Optional[torch.Generator] = None,
                       is_training: bool = False) -> torch.Tensor:
    """tgt [B, L, D] embedded target, memory [B, Lk, D], tgt_mask [B, L, L]
    and src_mask [B, 1, Lk] (0 = blocked) -> out [B, L, D]."""
    check_supported(cfg, is_training)
    L = tgt.shape[1]
    time_sig = position_signal(max(max_time, L), cfg.dim_model, tgt.device)
    layer_sig = position_signal(cfg.dec_layers, cfg.dim_model, tgt.device)
    if uses_act(cfg):
        x, _ = act_dec_apply(params["act_fn"], _layer_params(params, cfg, 0),
                                     cfg, tgt, memory, tgt_mask, src_mask, time_sig,
                                     layer_sig, cfg.act_max_hop or cfg.dec_layers)
    else:
        x = tgt + time_sig[:, :L].to(tgt.dtype)
        layer_sig = layer_sig[0].to(tgt.dtype)
        for hop in range(cfg.dec_layers):
            if cfg.transformer_type == "universal":
                x = x + layer_sig[hop]
            generator, k = split(generator)
            args = (_layer_params(params, cfg, hop), x, memory, cfg.num_heads)
            kw = dict(self_mask=tgt_mask, cross_mask=src_mask,
                      dropout_rate=cfg.dropout, training=is_training)
            if cfg.remat and is_training:
                x = checkpointed(decoder_layer, *args, generator=k, **kw)
            else:
                x = decoder_layer(*args, generator=k, **kw)
    return layer_norm(params["norm"], x, eps=1e-5)  # torch default eps, ref: TFDec.py:58


def tf_decoder_init_cache_chain(params: Dict, cfg: ModelConfig,
                                memory: torch.Tensor, max_len: int,
                                group: int,
                                cache_dtype: Optional[torch.dtype] = None
                                ) -> TFDecCache:
    """Zero self caches padded to pad_len(max_len, BLOCK), and the memory
    K/V projected once (memory zero-padded to pad_len(Lk, CROSS_BLOCK);
    padded rows project to 0 and are masked at attention time), all in
    cache_dtype (memory's dtype by default): the memory K/V are projected
    in memory's dtype, then cast (JAX tf_decoder_init_cache_flash). The
    hops of a universal decoder share one encdec_attn, so its memory K/V
    are projected once and every hop's entry is a view of them. The width
    of every cache follows the K projections: dim_model, or D / n_model
    for the params of one tensor-parallel shard (parallel/mesh.py)."""
    B, Lk, _ = memory.shape
    D = params["layers"][0]["decslf_attn"]["w_ks"]["w"].shape[1]
    mem = F.pad(memory, (0, 0, 0, pad_len(Lk, CROSS_BLOCK) - Lk))
    nl = cfg.dec_layers
    dt = cache_dtype or memory.dtype

    def project(key):
        if cfg.transformer_type == "universal":
            m = linear(params["layers"][0]["encdec_attn"][key], mem).to(dt)
            return m.expand(nl, *m.shape)
        return torch.stack([linear(lp["encdec_attn"][key], mem).to(dt)
                            for lp in params["layers"]]).contiguous()

    shape = (nl, group, B, pad_len(max_len, BLOCK), D)
    return TFDecCache(
        self_k=torch.zeros(shape, device=memory.device, dtype=dt),
        self_v=torch.zeros(shape, device=memory.device, dtype=dt),
        mem_k=project("w_ks"), mem_v=project("w_vs"))


def decode_signals(cfg: ModelConfig, max_time: int,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The position tables a decode loop adds, built on the device once per
    loop: the time signal [max_time, D] (row `pos` at position pos) and the
    layer signal [dec_layers, D] (row `hop` before hop hop, universal)."""
    return (position_signal(max_time, cfg.dim_model, device)[0],
            position_signal(cfg.dec_layers, cfg.dim_model, device)[0])


def tf_decoder_step_flash(params: Dict, cfg: ModelConfig, x_new: torch.Tensor,
                          cache: TFDecCache, pos: int, anc: torch.Tensor,
                          group: int, mem_mask_pad: torch.Tensor,
                          self_mask_k: torch.Tensor, time_sig: torch.Tensor,
                          layer_sig: torch.Tensor,
                          tp: Optional[ModelAxis] = None):
    """Decode position `pos` for x_new [B*K, D] (the embedded token), hop
    by hop: time_sig[pos], then per hop layer_sig[hop] (universal) and K5
    over that hop's caches, updated in place (the tables of
    decode_signals). The layers may be quantize_decoder_weights'd (a
    universal decoder's one shared layer included). Returns [B*K, D]
    before the final LayerNorm, which the head K7 applies.

    tp: the model axis of a tensor-parallel decode (ops/decode_flash_tp.py).
    params and cache are then per-shard lists (shard_params' decoder trees,
    each shard's caches of width D / n); every layer runs
    decoder_layer_step_flash_tp with n_head_local = num_heads * Dq / D
    (universal hops share the one sharded layer), and the result is the
    per-shard list of outputs, alike on every shard. x_new, anc, the masks
    and the signals lie on the first shard's device. ACT raises
    ValueError: its halting cannot be KV-cached."""
    check_supported(cfg)
    if uses_act(cfg):
        raise ValueError("ACT halting cannot be KV-cached: an ACT decoder re-runs "
                         "its token buffer each position (seq2seq._decode_logits_full)")
    x = x_new + time_sig[pos]
    if tp is not None:
        d_local = params[0]["layers"][0]["decslf_attn"]["w_qs"]["w"].shape[1]
        n_head_local = cfg.num_heads * d_local // cfg.dim_model
        xs = tp.replicate(x)
        anc_s, mem_s, self_s = (tp.replicate(t) for t in (anc, mem_mask_pad,
                                                         self_mask_k))
        lsig = tp.replicate(layer_sig)
        for hop in range(cfg.dec_layers):
            if cfg.transformer_type == "universal":
                xs = tp.fan(lambda s: xs[s] + lsig[s][hop])
            xs = decoder_layer_step_flash_tp(
                [_layer_params(p, cfg, hop) for p in params], xs,
                [c.self_k[hop] for c in cache], [c.self_v[hop] for c in cache],
                [c.mem_k[hop] for c in cache], [c.mem_v[hop] for c in cache],
                pos, n_head_local, anc_s, group, mem_s, self_s, tp)
        return xs
    for hop in range(cfg.dec_layers):
        if cfg.transformer_type == "universal":
            x = x + layer_sig[hop]
        x = decoder_layer_step_flash(
            _layer_params(params, cfg, hop), x, cache.self_k[hop],
            cache.self_v[hop], cache.mem_k[hop], cache.mem_v[hop], pos,
            cfg.num_heads, anc, group, mem_mask_pad, self_mask_k)
    return x


def tf_decoder_tp_position(shards: Sequence[Dict], cfg: ModelConfig,
                           memory: torch.Tensor, max_len: int, group: int,
                           cache_dtype: Optional[torch.dtype],
                           tp: ModelAxis) -> Callable:
    """The tensor-parallel decode state of one loop over shard_params'
    trees `shards` (one per shard of tp): each shard's caches on its own
    device (tf_decoder_init_cache_chain of its decoder, the memory copied
    there), and the function that decodes one position on them,

        position(x_new, pos, anc, mem_mask_pad, self_mask_k, time_sig,
                 layer_sig, topk, gather_ids=None)

    which runs tf_decoder_step_flash over the shards, then decode_head_tp,
    and returns shard 0's (scores, ids[, glp]) (alike on every shard)."""
    decs = [p["dec_tgt"] for p in shards]
    caches = [tf_decoder_init_cache_chain(d, cfg, memory.to(dv), max_len, group, cache_dtype)
              for d, dv in zip(decs, tp.devices)]
    norms, outs = [d["norm"] for d in decs], [p["out_tgt"] for p in shards]

    def position(x_new, pos, anc, mem_mask_pad, self_mask_k, time_sig, layer_sig,
                 topk, gather_ids=None):
        xs = tf_decoder_step_flash(decs, cfg, x_new, caches, pos, anc, group,
                                   mem_mask_pad, self_mask_k, time_sig, layer_sig, tp=tp)
        return tuple(t[0] for t in decode_head_tp(norms, outs, xs, topk, tp,
                                                  gather_ids=gather_ids))

    return position


def tf_decoder_chain_step(stacked: Tuple[torch.Tensor, ...], norm_params: Dict,
                          out_params: Dict, cfg: ModelConfig,
                          x_new: torch.Tensor, cache: TFDecCache, pos: int,
                          anc: torch.Tensor, group: int,
                          mem_mask_pad: torch.Tensor, self_mask_k: torch.Tensor,
                          topk: int, time_sig: torch.Tensor,
                          gather_ids: Optional[torch.Tensor] = None):
    """Decode position `pos` for x_new [B*K, D] (the embedded token): adds
    time_sig[pos] and runs all layers and the head through K3. `stacked` is
    stack_decoder_layers of the decoder's params (f32 or quantized), the
    (tensors, quant) pair a decode loop computes once; norm_params its
    final LayerNorm. Returns (scores
    [B*K, topk], ids [B*K, topk]) and, with gather_ids [B*K], the log-probs
    at those ids; the caches update in place. Standard type only."""
    if cfg.transformer_type != "standard":
        raise ValueError("the chain step runs the standard decoder; use "
                         "tf_decoder_step_flash for the universal one")
    return decode_chain_step_flash(
        stacked, norm_params, out_params, x_new + time_sig[pos], cache.self_k,
        cache.self_v, cache.mem_k, cache.mem_v, pos, cfg.num_heads, anc, group,
        mem_mask_pad, self_mask_k, topk, gather_ids=gather_ids)
