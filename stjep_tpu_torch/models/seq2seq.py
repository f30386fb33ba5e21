"""Composite Seq2seq, init and inference helpers (port of
stjep_tpu/models/seq2seq.py).

The parameter tree has the JAX package's key paths and `[in, out]`
layouts, so `bridge.params_from_numpy` carries JAX params over unchanged.
`enc_emb_proj` (static + dynamic -> dim_model) is always created and
applied, as in the reference (ref: Seq2seq.py:123-125). forward_train,
forward_eval and the greedy decoders are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.models.las import las_forward, las_init
from stjep_tpu_torch.models.las_decoder import embed, embedding_init
from stjep_tpu_torch.models.tf_decoder import tf_decoder_init
from stjep_tpu_torch.models.tf_encoder import (
    UPPERBOUND_SEQ_LEN,
    tf_encoder_forward,
    tf_encoder_init,
)
from stjep_tpu_torch.ops.attention import linear, linear_init
from stjep_tpu_torch.ops.masks import pad_mask, subsequent_mask


def init_seq2seq(cfg: ModelConfig, generator: torch.Generator,
                 device=None) -> Dict:
    """Random parameters with the key paths and shapes of
    stjep_tpu.models.seq2seq.init_seq2seq (values differ: the generators
    differ)."""
    g = generator
    params: Dict = {
        "enc_embedder": embedding_init(g, cfg.enc_vocab_size,
                                       cfg.enc_embedding_size, device)}
    if cfg.share_embedder:
        if cfg.enc_vocab_size != cfg.dec_vocab_size:
            raise ValueError("share_embedder needs equal vocab sizes")
        params["dec_embedder"] = params["enc_embedder"].clone()
    else:
        params["dec_embedder"] = embedding_init(g, cfg.dec_vocab_size,
                                                cfg.dec_embedding_size, device)
    params["enc_emb_proj"] = linear_init(
        g, cfg.enc_embedding_size + cfg.dim_model, cfg.dim_model, bias=False,
        device=device)
    if cfg.dec_emb_proj_flag:
        params["dec_emb_proj"] = linear_init(g, cfg.dec_embedding_size,
                                             cfg.dim_model, bias=False,
                                             device=device)
    if cfg.has_las:
        params["las"] = las_init(g, cfg, device)
    if cfg.has_transformer:
        params["enc_src"] = tf_encoder_init(g, cfg, device)
        params["dec_tgt"] = tf_decoder_init(g, cfg, device)
        params["out_tgt"] = linear_init(g, cfg.dim_model, cfg.dec_vocab_size,
                                        bias=False, device=device)
    params["emb_dyn_ave"] = torch.zeros((cfg.dim_model,), device=device)
    return params


def _get_src_emb(params: Dict, cfg: ModelConfig, src: torch.Tensor,
                 emb_src_dyn: torch.Tensor):
    """(src_mask [B,L,L], emb_src [B,L,D], src_mask_input [B,1,L]);
    emb_src = enc_emb_proj([static ; dynamic]) (ref: Seq2seq.py:183-199)."""
    src_mask_input = pad_mask(src)
    src_mask = src_mask_input & subsequent_mask(src.shape[-1], src.device)
    emb_static = embed(params["enc_embedder"], src)
    emb_comb = torch.cat([emb_static, emb_src_dyn.to(emb_static.dtype)], dim=2)
    return src_mask, linear(params["enc_emb_proj"], emb_comb), src_mask_input


def _dec_embedder(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Target embedding table; share_embedder ties it to the source table."""
    return params["enc_embedder"] if cfg.share_embedder else params["dec_embedder"]


def _embed_tgt_token(params: Dict, cfg: ModelConfig, token: torch.Tensor):
    """Single-position target embedding for incremental decode."""
    e = embed(_dec_embedder(params, cfg), token)
    if cfg.dec_emb_proj_flag:
        e = linear(params["dec_emb_proj"], e)
    return e


def _pre_proc_src(src: torch.Tensor) -> torch.Tensor:
    """Drop the initial BOS to align with the LAS decoder output."""
    return src[:, 1:]


def _encoder_acous(params: Dict, cfg: ModelConfig, acous_feats: torch.Tensor,
                   acous_lens: Optional[torch.Tensor],
                   max_seq_len: Optional[int] = None):
    """Free-running LAS pass -> (dynamic embs, None, preds, lengths)."""
    return las_forward(params["las"], cfg, acous_feats, acous_lens=acous_lens,
                       max_seq_len=max_seq_len)


def _encoder_en(params: Dict, cfg: ModelConfig, emb_src: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                max_time: int = UPPERBOUND_SEQ_LEN) -> torch.Tensor:
    return tf_encoder_forward(params["enc_src"], cfg, emb_src,
                              src_mask=src_mask, max_time=max_time)


def _length_src_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> [B, 1, max_len] bool (ref: Seq2seq.py:494-497)."""
    ar = torch.arange(max_len, device=lengths.device)[None, :]
    return (ar < lengths[:, None])[:, None, :]
