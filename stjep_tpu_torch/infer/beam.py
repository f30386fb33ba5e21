"""Batched beam search over the decode kernels (port of the kernel route of
stjep_tpu/infer/beam.py `_beam_search_flash`).

Position 1 runs K3 (`decode_chain_step_flash`) and keeps beam 0's K
candidates (ref: Seq2seq.py:349-356); positions 2.. run K4
(`decode_beam_step_flash`), the whole k^2 -> k step, until `max_seq_len`
or until every beam has emitted EOS. The all-EOS flag is read on the host
once per step. Caches are never reordered: the ancestry map `anc` records
which slot holds each hypothesis's K/V per position. Returns beam 0 per
batch item, as the reference's output does.

The megastep needs no decoder-side embedding projection and a target table
of at most 4 MB (`beam.py:371-372`); the other routes are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from stjep_tpu_torch.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu_torch.models.seq2seq import _dec_embedder, _embed_tgt_token
from stjep_tpu_torch.models.tf_decoder import (
    tf_decoder_chain_step,
    tf_decoder_init_cache_chain,
)
from stjep_tpu_torch.ops.decode_flash import (
    BLOCK,
    CROSS_BLOCK,
    decode_beam_step_flash,
    pad_len,
    stack_decoder_layers,
)
from stjep_tpu_torch.ops.masks import position_signal


def beam_search(params: Dict, cfg: ModelConfig, enc_outputs: torch.Tensor,
                mem_mask_b: Optional[torch.Tensor], beam_width: int,
                penalty_factor: float, max_seq_len: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc_outputs [B, Lk, D], mem_mask_b [B, Lk] bool (True = attend).
    Returns (preds [B, max_seq_len] best-beam tokens, BOS first,
    PAD-padded; scores [B])."""
    emb_table = _dec_embedder(params, cfg)
    if cfg.dec_emb_proj_flag or emb_table.numel() * 4 > 4 * 1024 * 1024:
        raise NotImplementedError(
            "only the beam megastep route is ported (no dec_emb_proj, target "
            "table <= 4 MB); see ROADMAP Queue B")
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

    dec = params["dec_tgt"]
    cache = tf_decoder_init_cache_chain(dec, cfg, enc_outputs, max_seq_len, K)
    preds = torch.full((BK, Lbuf), PAD, dtype=i32, device=dev)
    preds[:, 0] = BOS
    own = torch.arange(BK, device=dev, dtype=i32) % K
    anc = own[None, :].repeat(Lbuf, 1)
    maskk = (preds != PAD).T.to(i32).contiguous()

    # position 1: keep beam 0's K candidates; ancestry stays all-self
    emb = _embed_tgt_token(params, cfg, preds[:, 0])
    score_k, pred_k = tf_decoder_chain_step(
        dec, params["out_tgt"], cfg, emb, cache, 0, anc, K, mem_mask_t, maskk,
        K, max_time=max_time)
    scores = score_k.reshape(B, K * K)[:, :K].reshape(-1).contiguous()
    last_tok = pred_k.reshape(B, K * K)[:, :K].reshape(-1).contiguous()
    preds[:, 1] = last_tok
    maskk[1] = (last_tok != PAD).to(i32)
    eos = (last_tok == EOS).to(i32)
    lenm = 1.0 + (eos == 0).to(torch.float32)
    done = bool(eos.all())

    stacked = stack_decoder_layers(dec)
    tsig = position_signal(max_time, cfg.dim_model, dev)[0].contiguous()
    table = emb_table.contiguous()
    i = 2
    while i < max_seq_len and not done:
        (preds, anc, maskk, last_tok, scores, eos, lenm,
         flag) = decode_beam_step_flash(
            stacked, dec["norm"], params["out_tgt"], table, tsig, i, last_tok,
            preds, anc, maskk, mem_mask_t, scores, eos, lenm, cache.self_k,
            cache.self_v, cache.mem_k, cache.mem_v, cfg.num_heads, K,
            penalty_factor)
        done = bool(flag.item())  # one host read per step
        i += 1
    return (preds.reshape(B, K, Lbuf)[:, 0, :max_seq_len],
            scores.reshape(B, K)[:, 0])
