"""Batched beam search over the decode kernels (port of the kernel route of
stjep_tpu/infer/beam.py `_beam_search_flash`).

Position 1 keeps beam 0's K candidates (ref: Seq2seq.py:349-356). Each
position runs `decode_pos`: for the standard decoder K3
(`decode_chain_step_flash`, all layers and the head); for the universal one
K5 (`decoder_layer_step_flash`) per hop, then the head K7 (`decode_head`).
From position 2 on, two loops, where JAX has them (beam.py:371-372):

- the megastep K4 (`decode_beam_step_flash`, the whole k^2 -> k step in one
  call) for a standard decoder without a decoder-side embedding projection
  and with a target table of at most 4 MB;
- otherwise the general loop: anc[pos] set to each row's own slot, then
  `decode_pos`, and the k^2 -> k select with its back-copies
  (`beam_select`: on the card the select the megastep runs as its last
  phase).

Both run until `max_seq_len` or until every beam has emitted EOS; the
all-EOS flag is read on the host once per step. From position 1 to the
loop's end is the span `stjep.decode.beam_loop`, and each read of the flag
the span `stjep.decode.flag_read`, one a position (utils/profiling.py
`span`). The serving options
(beam.py:263-272 and the caches' dtype): `weight_dtype="int8"` quantizes
the decoder once before the loop (`quantize_decoder_weights`), and
`cache_dtype=torch.bfloat16` keeps the self caches and memory K/V in bf16;
every route takes either, and both. Caches are never reordered:
the ancestry map `anc` records which slot holds each hypothesis's K/V per
position. Returns beam 0 per batch item, as the reference's output does.

An ACT decoder (universal with `cfg.act`) cannot be KV-cached: every
position re-runs its token buffer [B*K, max_seq_len] through the full
decoder (`_decode_logits_full`) over the memory expanded K times, takes
the top K of the log-softmax at the position, and the general loop's
k^2 -> k `beam_select` (whose back-copied ancestry and key mask no re-run
reads) keeps K: JAX's dense beam with `full_rerun` (beam.py:104-205).
`weight_dtype="int8"` raises there, as JAX's does (beam.py:88-91), and
`cache_dtype` has no cache to act on.

Under a kernel mesh (parallel/spmd.py `set_kernel_mesh`) `beam_search`
dispatches as JAX's does (beam.py:87-97): each data shard decodes its slice
of the batch, and with a model axis the shards decode tensor-parallel
(`tp`): `decode_pos` runs the trio per layer and `decode_head_tp` (the
chain and the megastep are off, JAX beam.py:287), then `beam_select` once.
An ACT decoder re-runs its buffer on the whole batch under a mesh too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from stjep_tpu_torch.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu_torch.models.seq2seq import _dec_embedder, _decode_logits_full, _embed_tgt_token
from stjep_tpu_torch.models.tf_encoder import uses_act
from stjep_tpu_torch.models.tf_decoder import (
    decode_signals,
    tf_decoder_chain_step,
    tf_decoder_init_cache_chain,
    tf_decoder_step_flash,
    tf_decoder_tp_position,
)
from stjep_tpu_torch.ops.decode_flash import (
    BLOCK,
    CROSS_BLOCK,
    beam_select,
    decode_beam_step_flash,
    decode_head,
    pad_len,
    quantize_decoder_weights,
    stack_decoder_layers,
    topk_lowest_index,
)
from stjep_tpu_torch.ops.decode_flash_tp import ModelAxis
from stjep_tpu_torch.parallel import spmd
from stjep_tpu_torch.utils.profiling import span

MEGASTEP_TABLE_BYTES = 4 * 1024 * 1024  # ref: beam.py:371-372


def beam_search(params: Dict, cfg: ModelConfig, enc_outputs: torch.Tensor,
                mem_mask_b: Optional[torch.Tensor], beam_width: int,
                penalty_factor: float, max_seq_len: int,
                cache_dtype: Optional[torch.dtype] = None,
                weight_dtype: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_outputs [B, Lk, D], mem_mask_b [B, Lk] bool (True = attend);
    cache_dtype None (f32), torch.float32 or torch.bfloat16; weight_dtype
    None or "int8". Returns (preds [B, max_seq_len] best-beam tokens, BOS
    first, PAD-padded; scores [B]). Under a kernel mesh the decode shards
    (parallel/spmd.py beam_search_flash_dp); int8 weights under a model
    axis raise a ValueError."""
    if weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype must be None or 'int8', got {weight_dtype!r}")
    if cache_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError("cache_dtype must be None, torch.float32 or "
                         f"torch.bfloat16, got {cache_dtype!r}")
    args = (params, cfg, enc_outputs, mem_mask_b, beam_width, penalty_factor,
            max_seq_len, cache_dtype, weight_dtype)
    if uses_act(cfg):  # the whole batch where the call runs, mesh or not
        if weight_dtype is not None:
            raise ValueError(
                "weight_dtype='int8' needs the fused decode kernels; an ACT "
                "decoder re-runs its token buffer each position instead")
        return _beam_search_flash(*args)
    if spmd.kernel_mesh() is not None:
        return spmd.beam_search_flash_dp(*args)
    return _beam_search_flash(*args)


def _beam_search_flash(params, cfg: ModelConfig, enc_outputs: torch.Tensor,
                       mem_mask_b: Optional[torch.Tensor], beam_width: int,
                       penalty_factor: float, max_seq_len: int,
                       cache_dtype: Optional[torch.dtype] = None,
                       weight_dtype: Optional[str] = None,
                       tp: Optional[ModelAxis] = None):
    """The beam on one device, or tensor-parallel over `tp`: params is
    then the list of shard_params' trees, one per shard of tp, and
    enc_outputs and mem_mask_b lie on the first shard's device, where the
    beam bookkeeping runs. beam_search's arguments and results."""
    dev = enc_outputs.device
    i32 = torch.int32
    B, Lk, D = enc_outputs.shape
    K = beam_width
    BK = B * K
    Lbuf = pad_len(max_seq_len, BLOCK)
    Lk_pad = pad_len(Lk, CROSS_BLOCK)
    max_time = max(max_seq_len, 500)
    if mem_mask_b is None:
        mem_mask_b = torch.ones((B, Lk), dtype=torch.bool, device=dev)
    mem_mask_t = F.pad(mem_mask_b.to(i32), (0, Lk_pad - Lk)).T.contiguous()

    full_rerun = uses_act(cfg)
    if full_rerun:  # a/a/a b/b/b: each row's memory beside its hypotheses
        enc_k, mem_k = (t.repeat_interleave(K, dim=0) for t in (enc_outputs, mem_mask_b))
    elif tp is None:
        dec = params["dec_tgt"]
        if weight_dtype == "int8":
            dec = quantize_decoder_weights(dec)  # once, outside the loop
        cache = tf_decoder_init_cache_chain(dec, cfg, enc_outputs, max_seq_len, K,
                                            cache_dtype)
    else:  # each shard's caches on its device; embedder and bookkeeping: shard 0
        tp_position = tf_decoder_tp_position(params, cfg, enc_outputs, max_seq_len, K,
                                             cache_dtype, tp)
        params = params[0]
    use_chain = tp is None and cfg.transformer_type == "standard"  # ref: chain_supported
    preds = torch.full((BK, Lbuf), PAD, dtype=i32, device=dev)
    preds[:, 0] = BOS
    own = torch.arange(BK, device=dev, dtype=i32) % K
    anc = own[None, :].repeat(Lbuf, 1)
    maskk = (preds != PAD).T.to(i32).contiguous()
    stacked = stack_decoder_layers(dec) if use_chain else None
    tsig, lsig = decode_signals(cfg, max_time, dev)

    def decode_pos(tok, pos, anc, maskk, preds):
        if full_rerun:
            logits = _decode_logits_full(params, cfg, preds[:, :max_seq_len], enc_k,
                                         mem_k, pos, max_time)
            sc, ids = topk_lowest_index(torch.log_softmax(logits, dim=-1), K)
            return sc, ids.to(i32)
        emb = _embed_tgt_token(params, cfg, tok)
        if use_chain:
            return tf_decoder_chain_step(
                stacked, dec["norm"], params["out_tgt"], cfg, emb, cache, pos,
                anc, K, mem_mask_t, maskk, K, tsig)
        if tp is not None:
            return tp_position(emb, pos, anc, mem_mask_t, maskk, tsig, lsig, K)
        x = tf_decoder_step_flash(dec, cfg, emb, cache, pos, anc, K, mem_mask_t,
                                  maskk, tsig, lsig)
        return decode_head(dec["norm"], params["out_tgt"], x, K)

    with span("stjep.decode.beam_loop"):
        # position 1: keep beam 0's K candidates; ancestry stays all-self
        score_k, pred_k = decode_pos(preds[:, 0], 0, anc, maskk, preds)
        scores = score_k.reshape(B, K * K)[:, :K].reshape(-1).contiguous()
        last_tok = pred_k.reshape(B, K * K)[:, :K].reshape(-1).contiguous()
        preds[:, 1] = last_tok
        maskk[1] = (last_tok != PAD).to(i32)
        eos = (last_tok == EOS).to(i32)
        lenm = 1.0 + (eos == 0).to(torch.float32)
        with span("stjep.decode.flag_read"):
            done = bool(eos.all())

        emb_table = _dec_embedder(params, cfg)
        use_mega = (use_chain and not cfg.dec_emb_proj_flag
                    and emb_table.numel() * 4 <= MEGASTEP_TABLE_BYTES)
        if use_mega:
            table = emb_table.contiguous()
        i = 2
        while i < max_seq_len and not done:
            if use_mega:
                out = decode_beam_step_flash(
                    stacked, dec["norm"], params["out_tgt"], table, tsig, i,
                    last_tok, preds, anc, maskk, mem_mask_t, scores, eos, lenm,
                    cache.self_k, cache.self_v, cache.mem_k, cache.mem_v,
                    cfg.num_heads, K, penalty_factor)
            else:
                anc[i - 1] = own  # position i-1's K/V is written into each row itself
                sc, ids = decode_pos(last_tok, i - 1, anc, maskk, preds)
                out = beam_select(sc, ids, scores, eos, lenm, preds, anc, maskk,
                                  i, K, penalty_factor)
            preds, anc, maskk, last_tok, scores, eos, lenm, flag = out
            with span("stjep.decode.flag_read"):
                done = bool(flag.item())  # one host read per step
            i += 1
    return (preds.reshape(B, K, Lbuf)[:, 0, :max_seq_len],
            scores.reshape(B, K)[:, 0])
