"""Composite Seq2seq: init, the training forward and the inference helpers
(port of stjep_tpu/models/seq2seq.py).

The parameter tree has the JAX package's key paths and `[in, out]`
layouts, so `bridge.params_from_numpy` carries JAX params over unchanged.
`enc_emb_proj` (static + dynamic -> dim_model) is always created and
applied, as in the reference (ref: Seq2seq.py:123-125). `forward_train`
runs modes ASR, MT, ST and ASR_ST (ST alone trains through the free-running
LAS decoder's differentiable step loop, as JAX through its XLA scan), and
the AE head in any mode that names it (`_decoder_en`, the LAS output layer
over the dynamic or the combined source embedding). `forward_eval` is the
greedy dev eval: with reference ids over the free-running LAS (K2) and the
kernel greedy decoder `_greedy_decode_flash`; without them (the dense
`logps_*` buffers, JAX's XLA while loop) over the LAS step loop and
`_greedy_decode` (K5 per hop, then a plain head). ACT models decode by
re-running their token buffer each position (`_decode_logits_full`), with
reference ids too (`_greedy_decode` plus `_pick`, as JAX).
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
    uses_act,
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
from stjep_tpu_torch.ops.transformer import dropout, layer_norm, split
from stjep_tpu_torch.parallel.mesh import Shards, join
from stjep_tpu_torch.parallel.spmd import greedy_decode_flash_dp


def init_seq2seq(cfg: ModelConfig, generator: torch.Generator,
                 device=None, dtype=torch.float32) -> Dict:
    """Random parameters with the key paths, shapes and dtype (every leaf
    `dtype`) of stjep_tpu.models.seq2seq.init_seq2seq (values differ: the
    generators differ; each leaf is drawn in f32 and stored in dtype)."""
    g = generator
    params: Dict = {
        "enc_embedder": embedding_init(g, cfg.enc_vocab_size,
                                       cfg.enc_embedding_size, device, dtype)}
    if cfg.share_embedder:
        if cfg.enc_vocab_size != cfg.dec_vocab_size:
            raise ValueError("share_embedder needs equal vocab sizes")
        params["dec_embedder"] = params["enc_embedder"].clone()
    else:
        params["dec_embedder"] = embedding_init(g, cfg.dec_vocab_size,
                                                cfg.dec_embedding_size, device, dtype)
    params["enc_emb_proj"] = linear_init(
        g, cfg.enc_embedding_size + cfg.dim_model, cfg.dim_model, bias=False,
        device=device, dtype=dtype)
    if cfg.dec_emb_proj_flag:
        params["dec_emb_proj"] = linear_init(g, cfg.dec_embedding_size,
                                             cfg.dim_model, bias=False,
                                             device=device, dtype=dtype)
    if cfg.has_las:
        params["las"] = las_init(g, cfg, device, dtype)
    if cfg.has_transformer:
        params["enc_src"] = tf_encoder_init(g, cfg, device, dtype)
        params["dec_tgt"] = tf_decoder_init(g, cfg, device, dtype)
        params["out_tgt"] = linear_init(g, cfg.dim_model, cfg.dec_vocab_size,
                                        bias=False, device=device, dtype=dtype)
    params["emb_dyn_ave"] = torch.zeros((cfg.dim_model,), device=device, dtype=dtype)
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
                   ref_tokens: Optional[torch.Tensor] = None,
                   teacher_forcing_ratio: Optional[float] = None,
                   flash_ok: bool = True, lm_fuse=None, want_logps: bool = True,
                   dense_logps: bool = False):
    """LAS pass -> (dynamic embs, logps or picked logps or None, preds,
    lengths); free running unless teacher_forcing (ref: Seq2seq.py:222-230).
    teacher_forcing_ratio: the reference's per-batch coin (las_decoder.py);
    flash_ok=False keeps K2, which has no backward, out of a free-running
    pass that is differentiated; lm_fuse: n-gram LM shallow fusion in the
    LAS decode; want_logps=False: no teacher-forced [B, L-1, V] log-probs;
    dense_logps: the free-running ones (las_decoder_forward)."""
    return las_forward(params["las"], cfg, acous_feats, acous_lens=acous_lens,
                       max_seq_len=max_seq_len, tgt=tgt,
                       use_teacher_forcing=teacher_forcing, generator=generator,
                       is_training=is_training, ref_tokens=ref_tokens,
                       teacher_forcing_ratio=teacher_forcing_ratio,
                       flash_ok=flash_ok, lm_fuse=lm_fuse, want_logps=want_logps,
                       dense_logps=dense_logps)


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
    without the [B, L, V] log-probability tensor. A vocabulary-split
    out_tgt (Shards, the Trainer's mesh) takes `_picked_split` there, with
    None for the logits."""
    dec_out = tf_decoder_forward(params["dec_tgt"], cfg, emb_tgt, enc_outputs,
                                 tgt_mask=tgt_mask, src_mask=src_mask,
                                 max_time=max_time, generator=generator,
                                 is_training=is_training)
    w = params["out_tgt"]["w"]
    if isinstance(w, Shards):
        if ref_pick_ids is not None:
            return (dec_out, None) + _picked_split(w, dec_out, ref_pick_ids)
        logits = dec_out @ join(w, 1, dec_out.device)
    else:
        logits = linear(params["out_tgt"], dec_out)
    preds = torch.argmax(logits, dim=2)  # == argmax of the log-softmax
    if ref_pick_ids is None:
        return dec_out, logits, F.log_softmax(logits, dim=2), preds
    lg = logits[:, :-1].float()  # reduced in f32 under bf16 params (JAX's casts)
    picked = (lg.gather(2, ref_pick_ids.long()[:, :, None])[:, :, 0]
              - torch.logsumexp(lg, dim=-1))
    return dec_out, logits, picked, preds


def _picked_split(w: Shards, dec_out: torch.Tensor, ref_pick_ids: torch.Tensor):
    """The vocabulary-split head (out_tgt.w's slices, shard s holding ids
    [s V/n, (s+1) V/n)): (picked [B, L-1], preds [B, L]) as _decoder_de
    gives them, without the whole logits. The log-softmax normaliser is
    taken across the shards (max, then the sum of exp in shard order); the
    picked logit is the one shard holding each id; preds take each shard's
    first maximum and then the first shard with the largest one, the
    lowest id among ties as torch.argmax."""
    lead = dec_out.device
    vs = w[0].shape[1]
    ids = ref_pick_ids.long().to(lead)
    owner = ids // vs
    parts = [dec_out.to(s.device) @ s for s in w]
    lgs = [p[:, :-1].float().to(lead) for p in parts]  # f32, as the unsharded head
    mx = torch.stack([lg.detach().amax(-1) for lg in lgs]).amax(0)
    se = None
    picked = torch.zeros_like(mx)
    for s, lg in enumerate(lgs):
        e = torch.exp(lg - mx[..., None]).sum(-1)
        se = e if se is None else se + e
        at = lg.gather(2, (ids - s * vs).clamp(0, vs - 1)[..., None])[..., 0]
        picked = picked + torch.where(owner == s, at, torch.zeros_like(at))
    picked = picked - (mx + torch.log(se))
    with torch.no_grad():
        best = [p.to(lead).max(-1) for p in parts]
        vals = torch.stack([b.values for b in best])
        shard = torch.argmax(vals, 0)
        local = torch.stack([b.indices for b in best]).gather(0, shard[None])[0]
        preds = local + shard * vs
    return picked, preds


def _decoder_en(params: Dict, emb: torch.Tensor):
    """The AE head, sharing the LAS output layer: (logits, logps, preds)
    (ref: Seq2seq.py:240-246, 172-173)."""
    logits = linear(params["las"]["decoder"]["acous_out"], emb)
    logps = F.log_softmax(logits, dim=2)
    return logits, logps, torch.argmax(logps, dim=2)


def _src_emb_ave(params: Dict, cfg: ModelConfig, src: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 is_training: bool = False):
    """_get_src_emb of src without its BOS over the average dynamic
    embedding (detached: a buffer, never trained): the source embedding of
    MT and of the src-only AE head."""
    src_trim = _pre_proc_src(src)
    B, Ls = src_trim.shape
    emb_dyn = params["emb_dyn_ave"].detach()[None, None, :].expand(B, Ls, cfg.dim_model)
    return _get_src_emb(params, cfg, src_trim, emb_dyn, generator=generator,
                        is_training=is_training)


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
    """Teacher-forced training forward for modes ASR, MT, ST and ASR_ST,
    and the AE head in the modes that name it (`logps_ae`, `preds_ae`: over
    the ASR head's dynamic embeddings with ASR, else over the combined
    source embedding) (ref: Seq2seq.py:396-509); ST alone runs the LAS
    free, without dropout or SpecAugment, on its differentiable step loop
    (ref: Seq2seq.py:484-487). Returns the reference's out_dict keys; with
    ref_pick the heads give `picked_*` [B, L-1] (the log-softmax at the
    reference token) instead of `logps_*` [B, L-1, V].

    `generator` (a host torch.Generator, as the JAX function's `rng`;
    seed 0 when None) is split where the JAX function splits its key.
    is_training turns dropout and SpecAugment on; the teacher-forcing
    structure is the same either way."""
    mode = mode.upper()
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

    if "AE" in mode:  # the AE head (ref: Seq2seq.py:240-246)
        if "ASR" in mode:
            emb_ae = out["emb_asr"]
        else:  # src only: the combined source embedding, dropout as MT's
            generator, k = split(generator)
            _, emb_ae, _ = _src_emb_ave(params, cfg, src, generator=k,
                                        is_training=is_training)
        _, out["logps_ae"], out["preds_ae"] = _decoder_en(params, emb_ae)

    if "MT" in mode:
        generator, k1, k2, k3, k4 = split(generator, 5)
        tgt_mask, emb_tgt = _get_tgt_emb(params, cfg, tgt, generator=k1,
                                         is_training=is_training)
        _, emb_src, src_mask_input = _src_emb_ave(params, cfg, src, generator=k2,
                                                  is_training=is_training)
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input,
                              generator=k3, is_training=is_training)
        _, _, logps_tgt, preds_tgt = _decoder_de(
            params, cfg, emb_tgt, enc_out, tgt_mask=tgt_mask,
            src_mask=src_mask_input, generator=k4, is_training=is_training,
            ref_pick_ids=tgt[:, 1:] if ref_pick else None)
        out["emb_mt"] = emb_src
        out["preds_mt"] = preds_tgt
        out["picked_mt" if ref_pick else "logps_mt"] = logps_tgt

    if "ST" in mode:
        generator, k1, k2, k3, k4, k5 = split(generator, 6)
        tgt_mask, emb_tgt = _get_tgt_emb(params, cfg, tgt, generator=k1,
                                         is_training=is_training)
        if "ASR" in mode:  # the ASR head's dynamic embeddings and lengths
            emb_dyn, lengths = out["emb_asr"], out["lengths_asr"]
        else:  # the free-running LAS (ref: Seq2seq.py:484-487)
            emb_dyn, _, _, lengths = _encoder_acous(
                params, cfg, acous_feats, acous_lens, tgt=src, generator=k5,
                is_training=False, flash_ok=False)
        src_trim = _pre_proc_src(src)
        _, emb_src, _ = _get_src_emb(params, cfg, src_trim, emb_dyn,
                                     generator=k2, is_training=is_training)
        src_mask_input = _length_src_mask(lengths, emb_src.shape[1])
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


def _decode_logits_full(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                        enc_outputs: torch.Tensor,
                        mem_mask_b: Optional[torch.Tensor], pos: int,
                        max_time: int) -> torch.Tensor:
    """Logits [B', V] at `pos`, re-running the whole token buffer [B', L]
    through the decoder (causal and PAD masks): ACT halting cannot be
    KV-cached (JAX seq2seq.py:369-400; the reference re-runs the prefix,
    ref: Seq2seq.py:577-586). The ACT loop runs while any position of the
    buffer runs, so the buffer's width and rows are JAX's: the greedy's
    [B, length_out], the beam's [B*K, max_seq_len]."""
    tgt_mask, emb = _get_tgt_emb(params, cfg, tokens)
    src_mask = mem_mask_b[:, None, :] if mem_mask_b is not None else None
    dec_out = tf_decoder_forward(params["dec_tgt"], cfg, emb, enc_outputs,
                                 tgt_mask=tgt_mask, src_mask=src_mask,
                                 max_time=max_time)
    return linear(params["out_tgt"], dec_out[:, pos])


def _dense_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The decoder's final LayerNorm (eps 1e-5), out_tgt and the
    log-softmax over x [B', D]: JAX's dense head, plain XLA there
    (seq2seq.py:402-427)."""
    return F.log_softmax(
        linear(params["out_tgt"], layer_norm(params["dec_tgt"]["norm"], x, eps=1e-5)), dim=-1)


def _greedy_decode(params: Dict, cfg: ModelConfig, enc_outputs: torch.Tensor,
                   mem_mask_b: Optional[torch.Tensor], length_out: int,
                   max_time: int):
    """Greedy transformer decode with the dense log-prob buffer (JAX
    seq2seq.py:430-474; ref: Seq2seq.py:260-304): tokens PAD-filled with
    BOS in slot 0, logps [B, length_out, V] filled with log(1/V), each
    position's argmax and log-probs written to its slot, early exit once
    every row has emitted EOS (one host read a position). An ACT decoder
    re-runs the token buffer each position (`_decode_logits_full`); the
    others run K5 per hop over KV caches (group 1, tf_decoder_step_flash),
    then `_dense_head`. Returns (tokens [B, length_out], logps)."""
    B, Lk, _ = enc_outputs.shape
    dev = enc_outputs.device
    i32 = torch.int32
    V = cfg.dec_vocab_size
    full_rerun = uses_act(cfg)
    tokens = torch.full((B, length_out), PAD, dtype=i32, device=dev)
    tokens[:, 0] = BOS
    logps = torch.full((B, length_out, V), math.log(1.0 / V), dtype=enc_outputs.dtype,
                       device=dev)
    if not full_rerun:
        Lbuf, Lk_pad = pad_len(length_out, BLOCK), pad_len(Lk, CROSS_BLOCK)
        mm = mem_mask_b if mem_mask_b is not None else torch.ones(
            (B, Lk), dtype=torch.bool, device=dev)
        mem_mask_t = F.pad(mm.to(i32), (0, Lk_pad - Lk)).T.contiguous()
        anc = torch.zeros((Lbuf, B), dtype=i32, device=dev)  # every row is its own group
        maskk = torch.zeros((Lbuf, B), dtype=i32, device=dev)
        maskk[0] = 1
        dec = params["dec_tgt"]
        cache = tf_decoder_init_cache_chain(dec, cfg, enc_outputs, length_out, 1)
        tsig, lsig = decode_signals(cfg, max_time, dev)
    eos = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(1, length_out):
        pos = i - 1
        if full_rerun:
            logp = F.log_softmax(_decode_logits_full(params, cfg, tokens, enc_outputs,
                                                     mem_mask_b, pos, max_time), dim=-1)
        else:
            emb = _embed_tgt_token(params, cfg, tokens[:, pos])
            x = tf_decoder_step_flash(dec, cfg, emb, cache, pos, anc, 1, mem_mask_t,
                                      maskk, tsig, lsig)
            logp = _dense_head(params, x)
        pred = torch.argmax(logp, dim=-1).to(i32)
        tokens[:, i] = pred
        logps[:, i] = logp.to(logps.dtype)
        if not full_rerun:
            maskk[i] = (pred != PAD).to(i32)
        eos |= pred == EOS
        if bool(eos.all()):
            break
    return tokens, logps


def _pick(logps: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """logps [B, L', V] aligned with refs[:, 1:] -> the log-prob at each
    reference token [B, min(L', Lr - 1)] (JAX seq2seq.py:619-625)."""
    tgt = refs[:, 1:]
    lp = logps[:, :tgt.shape[1]]
    return lp.gather(2, tgt[:, :lp.shape[1]].long()[:, :, None])[:, :, 0]


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
                 device="cuda", lm_fuse=None) -> Dict[str, torch.Tensor]:
    """Free-running greedy eval, modes ASR, ST, ASR_ST, MT and the AE
    modes (ref: Seq2seq.py:512-638; seq2seq.py:586-724).

    ref_src [B, Ls] / ref_tgt [B, Lt] (BOS first) turn the per-vocab
    outputs into `picked_*` [B, L-1]: the free-running log-prob at the
    reference token, aligned with refs[:, 1:], which is what dev NLL reads.
    Without them the dense buffers come back instead: `logps_asr`
    [B, max_seq_len_src - 1, V] from the LAS step loop, `logps_mt` /
    `logps_st` [B, max_seq_len_tgt, V] from `_greedy_decode` (slot 0 and
    the slots after an early exit hold log(1/V)). Returns the JAX keys:
    emb_asr, preds_asr, picked_asr or logps_asr, lengths_asr (ASR);
    logps_ae, preds_ae (AE: the LAS output layer over the ASR pass's
    dynamic embeddings with ASR in the mode, else over the combined source
    embedding of src, JAX :649-671); emb_mt, preds_mt, picked_mt or
    logps_mt (MT); emb_st, preds_st, picked_st or logps_st (ST). With
    refs the standard and universal decoders run the kernel greedy
    (`_greedy_decode_flash`), an ACT decoder `_greedy_decode` and `_pick`,
    as JAX routes them. `device`: where the call runs, the card unless the
    caller asks for the CPU (the plain routes); the inputs move there, and
    params must already lie there (ValueError otherwise). Eval draws no
    random numbers, so the JAX function's `rng` has no counterpart.
    lm_fuse applies n-gram shallow fusion inside the LAS passes (the step
    loop instead of K2), as the reference's lm_mode/lm_model do (ref:
    Seq2seq.py:548,607). The dense routes and ACT run the whole batch where
    the call runs, under a kernel mesh too (parallel/spmd.py)."""
    mode = mode.upper()
    if ("ST" in mode or "ASR" in mode) and acous_feats is None:
        raise ValueError(f"mode {mode} needs acous_feats")
    if ("MT" in mode or "AE" in mode) and src is None:  # JAX :629-630
        raise ValueError(f"mode {mode} needs src")
    device = check_params_device(params, device)
    src, acous_feats, acous_lens, ref_src, ref_tgt = (
        t if t is None else t.to(device)
        for t in (src, acous_feats, acous_lens, ref_src, ref_tgt))
    out: Dict[str, torch.Tensor] = {}
    length_out = cfg.max_seq_len_tgt
    max_time = max(UPPERBOUND_SEQ_LEN, length_out)

    if "ASR" in mode:
        emb, lp_or_picked, preds, lengths = _encoder_acous(
            params, cfg, acous_feats, acous_lens, max_seq_len=cfg.max_seq_len_src,
            ref_tokens=ref_src[:, 1:] if ref_src is not None else None,
            lm_fuse=lm_fuse, dense_logps=ref_src is None)
        out.update(emb_asr=emb, preds_asr=preds, lengths_asr=lengths)
        out["picked_asr" if ref_src is not None else "logps_asr"] = lp_or_picked

    if "AE" in mode:
        emb_ae = out["emb_asr"] if "ASR" in mode else _src_emb_ave(params, cfg, src)[1]
        _, out["logps_ae"], out["preds_ae"] = _decoder_en(params, emb_ae)

    def greedy_head(enc_out, src_mask_input, key):
        mem_mask_b = src_mask_input[:, 0, :]
        if ref_tgt is not None and not uses_act(cfg):
            preds, picked = greedy_decode_flash_dp(
                params, cfg, enc_out, mem_mask_b, length_out, max_time, ref_tgt)
            out["preds_" + key] = preds
            out["picked_" + key] = picked[:, 1:][:, :ref_tgt.shape[1] - 1]
            return
        preds, logps = _greedy_decode(params, cfg, enc_out, mem_mask_b, length_out,
                                      max_time)
        out["preds_" + key] = preds
        if ref_tgt is not None:
            out["picked_" + key] = _pick(logps[:, 1:], ref_tgt)
        else:
            out["logps_" + key] = logps

    if "MT" in mode:
        _, emb_src, src_mask_input = _src_emb_ave(params, cfg, src)
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
                max_seq_len=cfg.max_seq_len_src, lm_fuse=lm_fuse)
        # static embeddings of the ASR *hypotheses* (ref: Seq2seq.py:608)
        _, emb_src, _ = _get_src_emb(params, cfg, preds_src, emb_dyn)
        src_mask_input = _length_src_mask(lengths, emb_src.shape[1])
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input)
        out["emb_st"] = emb_src
        greedy_head(enc_out, src_mask_input, "st")
    return out
