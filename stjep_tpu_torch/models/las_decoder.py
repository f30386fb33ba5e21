"""LAS attention decoder (port of stjep_tpu/models/las_decoder.py).

Each step feeds [embedding of the previous symbol ; previous dynamic
embedding] through a 3-layer residual uni-LSTM, attends bilinearly over the
pyramid output, and emits the dynamic embedding FFN([context ; query]) and
a greedy symbol (ref: models/Dec.py:344-438).

Free running (eval), the whole loop runs through K2 (`ops/las_flash.py`).
Statically teacher-forced (training), the symbols are the reference's, so
the head leaves the loop: the embedding side of layer 0 is one matmul over
all steps (`pre0`), the recurrence runs through K9 (`ops/las_tf_flash.py`,
differentiable), and the [Hs, V] head, the argmax symbols, the lengths and
the picked log-softmax are computed over all steps at once. The stochastic
teacher-forcing coin, hybrid attention and LM fusion are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from stjep_tpu_torch.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu_torch.ops.attention import (
    attention_init,
    linear,
    linear_init,
    precompute_keys,
)
from stjep_tpu_torch.ops.las_flash import las_greedy_flash
from stjep_tpu_torch.ops.las_tf_flash import las_tf_scan
from stjep_tpu_torch.ops.lstm import lstm_init
from stjep_tpu_torch.ops.masks import round_up8
from stjep_tpu_torch.ops.transformer import dropout, on_device, split


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup with padding_idx=PAD semantics: the PAD row reads 0."""
    return table[ids.long()] * (ids != PAD)[..., None].to(table.dtype)


def embedding_init(generator: torch.Generator, vocab_size: int, dim: int,
                   device=None) -> torch.Tensor:
    """torch nn.Embedding default init: N(0, 1), PAD row zeroed."""
    t = torch.randn((vocab_size, dim), generator=generator)
    t[PAD] = 0.0
    return t.to(device)


def las_decoder_init(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> Dict:
    E, Ha, Hd = cfg.enc_embedding_size, cfg.acous_hidden_size, cfg.dim_model
    Hs = cfg.dim_model
    params: Dict = {
        "embedder": embedding_init(generator, cfg.enc_vocab_size, E, device),
        "acous_att": attention_init(generator, query_size=Hd, key_size=2 * Ha,
                                    mode=cfg.acous_att_mode, device=device),
        "acous_ffn": linear_init(generator, 2 * Ha + Hd, Hs, bias=False, device=device),
        "acous_out": linear_init(generator, Hs, cfg.enc_vocab_size, device=device),
        "dec_l0": lstm_init(generator, E + Hs, Hd, device),
    }
    for i in range(1, cfg.num_unilstm_dec):
        params[f"dec_l{i}"] = lstm_init(generator, Hd, Hd, device)
    return params


def lengths_from_preds(preds: torch.Tensor, L: int) -> torch.Tensor:
    """First emission of EOS or PAD at step j gives length j + 1, else L
    (ref: Dec.py:334-341)."""
    eos = (preds == EOS) | (preds == PAD)
    first = torch.argmax(eos.int(), dim=1)
    return torch.where(eos.any(dim=1), first + 1, torch.full_like(first, L))


def _make_drop_masks(generator: torch.Generator, cfg: ModelConfig,
                     n_steps: int, B: int, Ha2: int, device):
    """Inverted-dropout masks for every step of the teacher-forced scan, in
    two draws: (lstm [L-1, n, B, Hd], ctx [L-1, B, 1, Ha2])."""
    keep = 1.0 - cfg.dropout
    shapes = ((n_steps, cfg.num_unilstm_dec, B, cfg.dim_model), (n_steps, B, 1, Ha2))
    return tuple((torch.rand(shape, generator=on_device(g, device), device=device)
                  < keep).float() / keep
                 for g, shape in zip(split(generator), shapes))


def _teacher_forced(params: Dict, cfg: ModelConfig, acous_outputs: torch.Tensor,
                    lens_k: torch.Tensor, tgt: torch.Tensor,
                    generator: Optional[torch.Generator], is_training: bool,
                    ref_tokens: Optional[torch.Tensor]):
    """The static teacher-forced branch (las_decoder.py:324-452)."""
    if cfg.num_unilstm_dec != 3:
        raise NotImplementedError("the teacher-forced scan (K9) runs the "
                                  "reference's 3 decoder LSTMs")
    B, _, Ha2 = acous_outputs.shape
    L = tgt.shape[1]
    emb_tgt = embed(params["embedder"], tgt)
    if is_training and cfg.embedding_dropout > 0.0:  # ref: Dec.py:166
        generator, k = split(generator)
        emb_tgt = dropout(k, emb_tgt, cfg.embedding_dropout, True)
    masks = None
    if is_training and cfg.dropout > 0.0:
        generator, k = split(generator)
        masks = _make_drop_masks(k, cfg, L - 1, B, Ha2, acous_outputs.device)
    p0 = params["dec_l0"]
    E = params["embedder"].shape[1]
    emb_steps = emb_tgt[:, :L - 1].transpose(0, 1)  # [L-1, B, E]
    pre0 = emb_steps @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]
    stack = {k: params[k] for k in ("dec_l0", "dec_l1", "dec_l2")}
    embs = las_tf_scan(stack, params["acous_att"]["linear_att_w"]["w"],
                       params["acous_ffn"]["w"], pre0, acous_outputs, lens_k,
                       masks).transpose(0, 1)  # [B, L-1, Hs]
    logits = linear(params["acous_out"], embs)
    symbols = torch.argmax(logits, dim=-1)  # == argmax of the log-softmax
    lengths = lengths_from_preds(symbols, L)
    if ref_tokens is None:
        return embs, torch.log_softmax(logits, dim=-1), symbols, lengths
    # the log-softmax at the reference token, by gather minus logsumexp
    ids = ref_tokens[:, :L - 1].long()[..., None]
    picked = logits.gather(-1, ids)[..., 0] - torch.logsumexp(logits, dim=-1)
    return embs, picked, symbols, lengths


def las_decoder_forward(params: Dict, cfg: ModelConfig,
                        acous_outputs: torch.Tensor,
                        acous_lens: Optional[torch.Tensor] = None,
                        max_seq_len: Optional[int] = None,
                        tgt: Optional[torch.Tensor] = None,
                        use_teacher_forcing: bool = False,
                        generator: Optional[torch.Generator] = None,
                        is_training: bool = False,
                        ref_tokens: Optional[torch.Tensor] = None):
    """Free running: greedy decode over max_seq_len - 1 steps, returning
    (sequence_embs [B, L-1, Hs], None, symbols [B, L-1], lengths [B]), the
    JAX function's return with want_logps=False; with ref_tokens, the
    second entry is the picked log-probs [B, L-1] at ref_tokens[:, :L-1]
    (PAD-padded to L-1, as las_decoder.py:308-312 pads them). Teacher-forced
    on tgt [B, L]: (sequence_embs, logps [B, L-1, V] or, with ref_tokens,
    the picked log-probs [B, L-1] at ref_tokens[:, :L-1], symbols,
    lengths)."""
    B, Tk, _ = acous_outputs.shape
    if acous_lens is not None:
        lens_k = round_up8(acous_lens.long()) // 8  # ref: Dec.py:173-179
    else:
        lens_k = torch.full((B,), Tk, dtype=torch.int64, device=acous_outputs.device)
    if use_teacher_forcing:
        if tgt is None:
            raise ValueError("teacher forcing needs tgt")
        return _teacher_forced(params, cfg, acous_outputs, lens_k, tgt,
                               generator, is_training, ref_tokens)
    L = max_seq_len if max_seq_len is not None else cfg.max_seq_len_src
    pre_keys = precompute_keys(params["acous_att"], acous_outputs, cfg.acous_att_mode)
    sym0 = torch.full((B,), BOS, dtype=torch.int64, device=acous_outputs.device)
    refs = None
    if ref_tokens is not None:  # K2 reads them as contiguous [B, L-1] int32
        r = ref_tokens[:, :L - 1].to(torch.int32)
        refs = F.pad(r, (0, L - 1 - r.shape[1]), value=PAD).contiguous()
    embs, preds, picked = las_greedy_flash(params, cfg, pre_keys["wk"],
                                           acous_outputs, lens_k, sym0, L - 1,
                                           ref_tokens=refs)
    return (embs, picked if refs is not None else None, preds,
            lengths_from_preds(preds, L))
