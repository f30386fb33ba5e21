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
the picked log-softmax are computed over all steps at once. Where JAX takes
its XLA scan of `las_decoder_step_core` instead of a kernel (attention other
than bilinear, widths off the kernels' tiles, a stack of other than 3
LSTMs for K9), the port runs the same step loop in plain PyTorch
(`_step_loop`), dispatched on JAX's conditions (`las_flash_supported`,
`use_tf_kernel`). The stochastic teacher-forcing coin and LM fusion are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from stjep_tpu_torch.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu_torch.ops.attention import (
    attend,
    attention_init,
    linear,
    linear_init,
    precompute_keys,
)
from stjep_tpu_torch.ops.las_flash import las_flash_supported, las_greedy_flash
from stjep_tpu_torch.ops.las_tf_flash import las_tf_flash_supported, las_tf_scan
from stjep_tpu_torch.ops.lstm import lstm_cell_step, lstm_gates, lstm_init
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


def _dec_lstm_stack(params: Dict, cfg: ModelConfig, x: torch.Tensor, h: List,
                    c: List, masks: Optional[torch.Tensor], pre0=None):
    """The residual uni-LSTM stack, one step (las_decoder.py `_dec_lstm_stack`):
    x [B, E + Hs] (only the cell-value half when pre0, the hoisted
    embedding side of layer 0, is given), masks [n, B, Hd] or None.
    Returns (out [B, Hd], h', c') with h'/c' lists over the layers."""
    if pre0 is not None:
        E = params["embedder"].shape[1]
        p0 = params["dec_l0"]
        h0, c0 = lstm_gates(pre0 + x @ p0["w_ih"][E:] + h[0] @ p0["w_hh"], c[0], h[0].shape[-1])
    else:
        h0, c0 = lstm_cell_step(params["dec_l0"], x, h[0], c[0])
    hs, cs = [h0], [c0]
    out = h0 if masks is None else h0 * masks[0]
    n = cfg.num_unilstm_dec
    for i in range(1, n):
        hi, ci = lstm_cell_step(params[f"dec_l{i}"], out, h[i], c[i])
        hs.append(hi)
        cs.append(ci)
        y = hi + out if i < n - 1 else hi  # residual on middle layers only
        out = y if masks is None else y * masks[i]
    return out, hs, cs


def _step_loop(params: Dict, cfg: ModelConfig, acous_outputs: torch.Tensor,
               att_mask: Optional[torch.Tensor], n_steps: int,
               pre0_steps: Optional[torch.Tensor] = None,
               sym0: Optional[torch.Tensor] = None, masks=None,
               ref_tokens: Optional[torch.Tensor] = None,
               pre_keys: Optional[Dict] = None, mode: Optional[str] = None):
    """JAX's scan of `las_decoder_step_core` (las_decoder.py:136-183,
    398-408, 454-504) in plain PyTorch, differentiable. Teacher forced with
    pre0_steps [n, B, 4Hd]: returns the dynamic embeddings [n, B, Hs]. Free
    running from sym0 [B]: returns (embs [B, n, Hs], greedy symbols [B, n],
    log-softmax at ref_tokens[:, step] [B, n], token 0 without refs).
    masks: (lstm [n, L, B, Hd], ctx [n, B, 1, Ha2]) or None. pre_keys and
    mode default to the keys precomputed here and cfg's attention mode."""
    B, Tk, _ = acous_outputs.shape
    Hd = cfg.dim_model
    att = params["acous_att"]
    mode = mode or cfg.acous_att_mode
    if pre_keys is None:
        pre_keys = precompute_keys(att, acous_outputs, mode)
    z = acous_outputs.new_zeros((B, Hd))
    h, c = [z] * cfg.num_unilstm_dec, [z] * cfg.num_unilstm_dec
    cell = acous_outputs.new_zeros((B, params["acous_ffn"]["w"].shape[1]))
    prev_c = acous_outputs.new_zeros((B, 1, Tk))
    sym = sym0
    embs, syms, picked = [], [], []
    for step in range(n_steps):
        m_lstm, m_ctx = (None, None) if masks is None else (masks[0][step], masks[1][step])
        if pre0_steps is not None:
            dec_out, h, c = _dec_lstm_stack(params, cfg, cell, h, c, m_lstm, pre0=pre0_steps[step])
        else:
            x = torch.cat([embed(params["embedder"], sym), cell], dim=-1)
            dec_out, h, c = _dec_lstm_stack(params, cfg, x, h, c, m_lstm)
        query = dec_out[:, None, :]
        ctx, _, c_out = attend(att, pre_keys, query, acous_outputs, mode,
                               mask=att_mask, prev_c=prev_c)
        if m_ctx is not None:
            ctx = ctx * m_ctx
        cell = linear(params["acous_ffn"], torch.cat([ctx, query], dim=-1))[:, 0]
        if c_out is not None:
            prev_c = c_out
        embs.append(cell)
        if pre0_steps is None:
            logp = torch.log_softmax(linear(params["acous_out"], cell), dim=-1)
            sym = torch.argmax(logp, dim=-1)
            syms.append(sym)
            ids = (ref_tokens[:, step:step + 1].long() if ref_tokens is not None
                   else torch.zeros_like(sym)[:, None])
            picked.append(logp.gather(1, ids)[:, 0])
    if pre0_steps is not None:
        return torch.stack(embs)
    return torch.stack(embs, dim=1), torch.stack(syms, dim=1), torch.stack(picked, dim=1)


def _att_mask(lens_k: torch.Tensor, Tk: int) -> torch.Tensor:
    """[B, Tk], True past a row's valid key positions (Dec.py:173-179)."""
    return torch.arange(Tk, device=lens_k.device)[None, :] >= lens_k[:, None]


def _teacher_forced(params: Dict, cfg: ModelConfig, acous_outputs: torch.Tensor,
                    lens_k: torch.Tensor, tgt: torch.Tensor,
                    generator: Optional[torch.Generator], is_training: bool,
                    ref_tokens: Optional[torch.Tensor]):
    """The static teacher-forced branch (las_decoder.py:324-452): K9 where
    JAX takes its kernel (`use_tf_kernel`, :376-383), else the step loop."""
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
    if cfg.num_unilstm_dec == 3 and las_tf_flash_supported(cfg):
        stack = {k: params[k] for k in ("dec_l0", "dec_l1", "dec_l2")}
        embs = las_tf_scan(stack, params["acous_att"]["linear_att_w"]["w"],
                           params["acous_ffn"]["w"], pre0, acous_outputs, lens_k,
                           masks)
    else:
        embs = _step_loop(params, cfg, acous_outputs, _att_mask(lens_k, acous_outputs.shape[1]),
                          L - 1, pre0_steps=pre0, masks=masks)
    embs = embs.transpose(0, 1)  # [B, L-1, Hs]
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
    sym0 = torch.full((B,), BOS, dtype=torch.int64, device=acous_outputs.device)
    refs = None
    if ref_tokens is not None:  # K2 reads them as contiguous [B, L-1] int32
        r = ref_tokens[:, :L - 1].to(torch.int32)
        refs = F.pad(r, (0, L - 1 - r.shape[1]), value=PAD).contiguous()
    if las_flash_supported(cfg):
        pre_keys = precompute_keys(params["acous_att"], acous_outputs, cfg.acous_att_mode)
        embs, preds, picked = las_greedy_flash(params, cfg, pre_keys["wk"],
                                               acous_outputs, lens_k, sym0, L - 1,
                                               ref_tokens=refs)
    else:
        embs, preds, picked = _step_loop(params, cfg, acous_outputs, _att_mask(lens_k, Tk),
                                         L - 1, sym0=sym0, ref_tokens=refs)
    return (embs, picked if refs is not None else None, preds,
            lengths_from_preds(preds, L))
