"""Composite Seq2seq: init, the training forward and the inference helpers
(port of stjep_tpu/models/seq2seq.py).

The parameter tree has the JAX package's key paths and `[in, out]`
layouts, so `bridge.params_from_numpy` carries JAX params over unchanged.
`enc_emb_proj` (static + dynamic -> dim_model) is always created and
applied, as in the reference (ref: Seq2seq.py:123-125). `forward_train`
runs modes ASR, MT and ASR_ST; ST alone (training through the free-running
LAS) and the AE modes are not ported yet. `forward_eval` is the dev eval
with reference ids, over the free-running LAS (K2) and the kernel greedy
decoder `_greedy_decode_flash`; without reference ids (the dense logps
buffers) and in the AE modes it is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from stjep_tpu_torch.bridge import check_params_device
from stjep_tpu_torch.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu_torch.models.las import las_forward, las_init
from stjep_tpu_torch.models.las_decoder import embed, embedding_init
from stjep_tpu_torch.models.tf_decoder import (
    decode_signals,
    tf_decoder_chain_step,
    tf_decoder_forward,
    tf_decoder_init,
    tf_decoder_init_cache_chain,
    tf_decoder_step_flash,
    tf_decoder_tp_position,
)
from stjep_tpu_torch.models.tf_encoder import (
    UPPERBOUND_SEQ_LEN,
    tf_encoder_forward,
    tf_encoder_init,
)
from stjep_tpu_torch.ops.attention import linear, linear_init
from stjep_tpu_torch.ops.decode_flash import (
    BLOCK,
    CROSS_BLOCK,
    decode_head_gather,
    pad_len,
    stack_decoder_layers,
)
from stjep_tpu_torch.ops.decode_flash_tp import ModelAxis
from stjep_tpu_torch.ops.masks import pad_mask, subsequent_mask
from stjep_tpu_torch.ops.transformer import dropout, split
from stjep_tpu_torch.parallel.spmd import greedy_decode_flash_dp


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
                 emb_src_dyn: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 is_training: bool = False):
    """(src_mask [B,L,L], emb_src [B,L,D], src_mask_input [B,1,L]);
    emb_src = enc_emb_proj([static ; dynamic]), with embedding dropout in
    training (ref: Seq2seq.py:183-199)."""
    src_mask_input = pad_mask(src)
    src_mask = src_mask_input & subsequent_mask(src.shape[-1], src.device)
    emb_static = embed(params["enc_embedder"], src)
    emb_comb = torch.cat([emb_static, emb_src_dyn.to(emb_static.dtype)], dim=2)
    if is_training and cfg.embedding_dropout > 0.0:
        emb_comb = dropout(generator, emb_comb, cfg.embedding_dropout, True)
    return src_mask, linear(params["enc_emb_proj"], emb_comb), src_mask_input


def _dec_embedder(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Target embedding table; share_embedder ties it to the source table."""
    return params["enc_embedder"] if cfg.share_embedder else params["dec_embedder"]


def _get_tgt_emb(params: Dict, cfg: ModelConfig, tgt: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 is_training: bool = False):
    """(tgt_mask [B,L,L], emb_tgt [B,L,D]) (ref: Seq2seq.py:202-211)."""
    tgt_mask = pad_mask(tgt) & subsequent_mask(tgt.shape[-1], tgt.device)
    e = embed(_dec_embedder(params, cfg), tgt)
    if is_training and cfg.embedding_dropout > 0.0:
        e = dropout(generator, e, cfg.embedding_dropout, True)
    if cfg.dec_emb_proj_flag:
        e = linear(params["dec_emb_proj"], e)
    return tgt_mask, e


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
                   max_seq_len: Optional[int] = None,
                   tgt: Optional[torch.Tensor] = None,
                   teacher_forcing: bool = False,
                   generator: Optional[torch.Generator] = None,
                   is_training: bool = False,
                   ref_tokens: Optional[torch.Tensor] = None):
    """LAS pass -> (dynamic embs, logps or picked logps or None, preds,
    lengths); free running unless teacher_forcing (ref: Seq2seq.py:222-230)."""
    return las_forward(params["las"], cfg, acous_feats, acous_lens=acous_lens,
                       max_seq_len=max_seq_len, tgt=tgt,
                       use_teacher_forcing=teacher_forcing, generator=generator,
                       is_training=is_training, ref_tokens=ref_tokens)


def _encoder_en(params: Dict, cfg: ModelConfig, emb_src: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None,
                max_time: int = UPPERBOUND_SEQ_LEN,
                generator: Optional[torch.Generator] = None,
                is_training: bool = False) -> torch.Tensor:
    return tf_encoder_forward(params["enc_src"], cfg, emb_src,
                              src_mask=src_mask, max_time=max_time,
                              generator=generator, is_training=is_training)


def _decoder_de(params: Dict, cfg: ModelConfig, emb_tgt: torch.Tensor,
                enc_outputs: torch.Tensor, tgt_mask: Optional[torch.Tensor] = None,
                src_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                is_training: bool = False, max_time: int = UPPERBOUND_SEQ_LEN,
                ref_pick_ids: Optional[torch.Tensor] = None):
    """(dec_outputs, logits, logps, preds) (ref: Seq2seq.py:249-257). With
    ref_pick_ids [B, L-1] (the shifted targets) the logps slot holds the
    log-softmax of logits[:, :-1] at those ids, by gather minus logsumexp,
    without the [B, L, V] log-probability tensor."""
    dec_out = tf_decoder_forward(params["dec_tgt"], cfg, emb_tgt, enc_outputs,
                                 tgt_mask=tgt_mask, src_mask=src_mask,
                                 max_time=max_time, generator=generator,
                                 is_training=is_training)
    logits = linear(params["out_tgt"], dec_out)
    preds = torch.argmax(logits, dim=2)  # == argmax of the log-softmax
    if ref_pick_ids is None:
        return dec_out, logits, F.log_softmax(logits, dim=2), preds
    lg = logits[:, :-1]
    picked = (lg.gather(2, ref_pick_ids.long()[:, :, None])[:, :, 0]
              - torch.logsumexp(lg, dim=-1))
    return dec_out, logits, picked, preds


def _length_src_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] -> [B, 1, max_len] bool (ref: Seq2seq.py:494-497)."""
    ar = torch.arange(max_len, device=lengths.device)[None, :]
    return (ar < lengths[:, None])[:, None, :]


def forward_train(params: Dict, cfg: ModelConfig, mode: str, src: torch.Tensor,
                  tgt: Optional[torch.Tensor] = None,
                  acous_feats: Optional[torch.Tensor] = None,
                  acous_lens: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  is_training: bool = True,
                  ref_pick: bool = False) -> Dict[str, torch.Tensor]:
    """Teacher-forced training forward for modes ASR, MT and ASR_ST
    (ref: Seq2seq.py:396-509). Returns the reference's out_dict keys; with
    ref_pick the heads give `picked_*` [B, L-1] (the log-softmax at the
    reference token) instead of `logps_*` [B, L-1, V].

    `generator` (a host torch.Generator, as the JAX function's `rng`;
    seed 0 when None) is split where the JAX function splits its key.
    is_training turns dropout and SpecAugment on; the teacher-forcing
    structure is the same either way."""
    mode = mode.upper()
    if "AE" in mode or ("ST" in mode and "ASR" not in mode):
        raise NotImplementedError(
            f"forward_train mode {mode!r} is not ported yet: ST alone trains "
            "through the free-running LAS and AE through its own head "
            "(ROADMAP Queue A item 7)")
    if ("ST" in mode or "ASR" in mode) and acous_feats is None:
        raise ValueError(f"mode {mode} needs acous_feats")
    if ("ST" in mode or "MT" in mode) and tgt is None:
        raise ValueError(f"mode {mode} needs tgt")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out: Dict[str, torch.Tensor] = {}

    if "ASR" in mode:
        generator, k = split(generator)
        emb_src, logps_src, preds_src, lengths = _encoder_acous(
            params, cfg, acous_feats, acous_lens, tgt=src, teacher_forcing=True,
            generator=k, is_training=is_training,
            ref_tokens=src[:, 1:] if ref_pick else None)
        out["emb_asr"] = emb_src
        out["preds_asr"] = preds_src
        out["picked_asr" if ref_pick else "logps_asr"] = logps_src
        out["lengths_asr"] = lengths

    if "MT" in mode:
        generator, k1, k2, k3, k4 = split(generator, 5)
        tgt_mask, emb_tgt = _get_tgt_emb(params, cfg, tgt, generator=k1,
                                         is_training=is_training)
        src_trim = _pre_proc_src(src)
        B, Ls = src_trim.shape
        emb_dyn = params["emb_dyn_ave"].detach()[None, None, :].expand(
            B, Ls, cfg.dim_model)
        _, emb_src, src_mask_input = _get_src_emb(
            params, cfg, src_trim, emb_dyn, generator=k2, is_training=is_training)
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input,
                              generator=k3, is_training=is_training)
        _, _, logps_tgt, preds_tgt = _decoder_de(
            params, cfg, emb_tgt, enc_out, tgt_mask=tgt_mask,
            src_mask=src_mask_input, generator=k4, is_training=is_training,
            ref_pick_ids=tgt[:, 1:] if ref_pick else None)
        out["emb_mt"] = emb_src
        out["preds_mt"] = preds_tgt
        out["picked_mt" if ref_pick else "logps_mt"] = logps_tgt

    if "ST" in mode:  # ASR_ST: the ASR head's dynamic embeddings and lengths
        generator, k1, k2, k3, k4, _ = split(generator, 6)
        tgt_mask, emb_tgt = _get_tgt_emb(params, cfg, tgt, generator=k1,
                                         is_training=is_training)
        src_trim = _pre_proc_src(src)
        _, emb_src, _ = _get_src_emb(params, cfg, src_trim, out["emb_asr"],
                                     generator=k2, is_training=is_training)
        src_mask_input = _length_src_mask(out["lengths_asr"], emb_src.shape[1])
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input,
                              generator=k3, is_training=is_training)
        _, _, logps_tgt, preds_tgt = _decoder_de(
            params, cfg, emb_tgt, enc_out, tgt_mask=tgt_mask,
            src_mask=src_mask_input, generator=k4, is_training=is_training,
            ref_pick_ids=tgt[:, 1:] if ref_pick else None)
        out["emb_st"] = emb_src
        out["preds_st"] = preds_tgt
        out["picked_st" if ref_pick else "logps_st"] = logps_tgt
    return out


def _greedy_decode_flash(params: Dict, cfg: ModelConfig,
                         enc_outputs: torch.Tensor,
                         mem_mask_b: Optional[torch.Tensor], length_out: int,
                         max_time: int, ref_tokens: torch.Tensor,
                         tp: Optional[ModelAxis] = None):
    """Greedy transformer decode over the decode kernels (group 1), with
    the buffer semantics of the reference's greedy eval (ref:
    Seq2seq.py:260-304): tokens PAD-filled with BOS in slot 0, early exit
    once every row has emitted EOS (one host read of the flag per step).
    Instead of the [B, L, V] log-prob buffer it returns picked [B, L], the
    log-prob at ref_tokens[:, i] for each written slot i; unwritten slots
    keep the dense buffer's log(1/V) (ref: seq2seq.py:485-583). Standard
    decoders run K3 with its gather per position; other types K5 per hop
    and then K7's gather variant. With `tp`, tensor-parallel: params is the
    list of shard_params' trees and every position runs the trio per layer
    and decode_head_tp with the gather at top-1 (JAX seq2seq.py:554-563);
    the inputs lie on the first shard's device. Returns (tokens
    [B, length_out], picked [B, length_out])."""
    if tp is not None:
        tp_position = tf_decoder_tp_position(params, cfg, enc_outputs, length_out, 1, None, tp)
        params = params[0]
    B, Lk, _ = enc_outputs.shape
    dev = enc_outputs.device
    i32 = torch.int32
    Lbuf = pad_len(length_out, BLOCK)
    Lk_pad = pad_len(Lk, CROSS_BLOCK)
    if mem_mask_b is None:
        mem_mask_b = torch.ones((B, Lk), dtype=torch.bool, device=dev)
    mem_mask_t = F.pad(mem_mask_b.to(i32), (0, Lk_pad - Lk)).T.contiguous()
    refs = F.pad(ref_tokens.to(i32), (0, max(0, Lbuf - ref_tokens.shape[1])))
    anc = torch.zeros((Lbuf, B), dtype=i32, device=dev)  # every row is its own group
    dec, out_p = params["dec_tgt"], params["out_tgt"]
    if tp is None:
        cache = tf_decoder_init_cache_chain(dec, cfg, enc_outputs, length_out, 1)
    tokens = torch.full((B, Lbuf), PAD, dtype=i32, device=dev)
    tokens[:, 0] = BOS
    picked = torch.full((B, Lbuf), math.log(1.0 / cfg.dec_vocab_size),
                        dtype=torch.float32, device=dev)
    maskk = (tokens != PAD).T.to(i32).contiguous()
    eos = torch.zeros((B,), dtype=torch.bool, device=dev)
    use_chain = tp is None and cfg.transformer_type == "standard"  # ref: chain_supported
    stacked = stack_decoder_layers(dec) if use_chain else None
    tsig, lsig = decode_signals(cfg, max_time, dev)
    for i in range(1, length_out):
        pos = i - 1
        emb = _embed_tgt_token(params, cfg, tokens[:, pos])
        gid = refs[:, i].contiguous()
        if use_chain:
            _, pred1, ref_lp = tf_decoder_chain_step(
                stacked, dec["norm"], out_p, cfg, emb, cache, pos, anc, 1,
                mem_mask_t, maskk, 1, tsig, gather_ids=gid)
        elif tp is not None:
            _, pred1, ref_lp = tp_position(emb, pos, anc, mem_mask_t, maskk, tsig, lsig, 1,
                                           gather_ids=gid)
        else:
            x = tf_decoder_step_flash(dec, cfg, emb, cache, pos, anc, 1,
                                      mem_mask_t, maskk, tsig, lsig)
            _, pred1, ref_lp = decode_head_gather(dec["norm"], out_p, x, 1, gid)
        pred = pred1[:, 0]
        tokens[:, i] = pred
        picked[:, i] = ref_lp
        maskk[i] = (pred != PAD).to(i32)
        eos |= pred == EOS
        if bool(eos.all()):
            break
    return tokens[:, :length_out], picked[:, :length_out]


@torch.no_grad()
def forward_eval(params: Dict, cfg: ModelConfig, mode: str,
                 src: Optional[torch.Tensor] = None,
                 acous_feats: Optional[torch.Tensor] = None,
                 acous_lens: Optional[torch.Tensor] = None,
                 ref_src: Optional[torch.Tensor] = None,
                 ref_tgt: Optional[torch.Tensor] = None,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Free-running greedy dev eval with reference ids, modes ASR, ST,
    ASR_ST and MT (ref: Seq2seq.py:512-638; seq2seq.py:586-724).

    ref_src [B, Ls] / ref_tgt [B, Lt] (BOS first) turn the per-vocab
    outputs into `picked_*` [B, L-1]: the free-running log-prob at the
    reference token, aligned with refs[:, 1:], which is what dev NLL reads.
    Returns the JAX keys: emb_asr, preds_asr, picked_asr, lengths_asr
    (ASR); emb_mt, preds_mt, picked_mt (MT); emb_st, preds_st, picked_st
    (ST). `device`: where the call runs, the card unless the caller asks
    for the CPU (the plain routes); the inputs move there, and params must
    already lie there (ValueError otherwise). Eval draws no random numbers,
    so the JAX function's `rng` has no counterpart. LM fusion is not
    ported."""
    mode = mode.upper()
    if "AE" in mode:
        raise NotImplementedError(
            f"forward_eval mode {mode!r} is not ported yet: the AE head "
            "(ROADMAP Queue A item 11)")
    if ("ASR" in mode and ref_src is None) or (
            ("ST" in mode or "MT" in mode) and ref_tgt is None):
        raise NotImplementedError(
            "forward_eval without reference ids (the dense logps_* buffers) "
            "is not ported yet (ROADMAP Queue A item 11)")
    if ("ST" in mode or "ASR" in mode) and acous_feats is None:
        raise ValueError(f"mode {mode} needs acous_feats")
    if "MT" in mode and src is None:
        raise ValueError(f"mode {mode} needs src")
    device = check_params_device(params, device)
    src, acous_feats, acous_lens, ref_src, ref_tgt = (
        t if t is None else t.to(device)
        for t in (src, acous_feats, acous_lens, ref_src, ref_tgt))
    out: Dict[str, torch.Tensor] = {}
    length_out = cfg.max_seq_len_tgt
    max_time = max(UPPERBOUND_SEQ_LEN, length_out)

    if "ASR" in mode:
        emb, picked, preds, lengths = _encoder_acous(
            params, cfg, acous_feats, acous_lens,
            max_seq_len=cfg.max_seq_len_src, ref_tokens=ref_src[:, 1:])
        out.update(emb_asr=emb, preds_asr=preds, lengths_asr=lengths,
                   picked_asr=picked)

    def greedy_head(enc_out, src_mask_input, key):
        preds, picked = greedy_decode_flash_dp(
            params, cfg, enc_out, src_mask_input[:, 0, :], length_out,
            max_time, ref_tgt)
        out["preds_" + key] = preds
        out["picked_" + key] = picked[:, 1:][:, :ref_tgt.shape[1] - 1]

    if "MT" in mode:
        src_trim = _pre_proc_src(src)
        B, Ls = src_trim.shape
        emb_dyn = params["emb_dyn_ave"][None, None, :].expand(B, Ls, cfg.dim_model)
        _, emb_src, src_mask_input = _get_src_emb(params, cfg, src_trim, emb_dyn)
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input)
        out["emb_mt"] = emb_src
        greedy_head(enc_out, src_mask_input, "mt")

    if "ST" in mode:
        if "ASR" in mode:
            emb_dyn, preds_src, lengths = (out["emb_asr"], out["preds_asr"],
                                           out["lengths_asr"])
        else:
            emb_dyn, _, preds_src, lengths = _encoder_acous(
                params, cfg, acous_feats, acous_lens,
                max_seq_len=cfg.max_seq_len_src)
        # static embeddings of the ASR *hypotheses* (ref: Seq2seq.py:608)
        _, emb_src, _ = _get_src_emb(params, cfg, preds_src, emb_dyn)
        src_mask_input = _length_src_mask(lengths, emb_src.shape[1])
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input)
        out["emb_st"] = emb_src
        greedy_head(enc_out, src_mask_input, "st")
    return out
