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
`use_tf_kernel`). The step loop also runs free-running decodes that are
differentiated (ST-alone training, `flash_ok=False`), since K2 has no
backward, as JAX runs its XLA scan there. The stochastic teacher-forcing
coin (`teacher_forcing_ratio`) is one host draw from the generator where
JAX draws a traced bernoulli: the branch it picks then runs as the static
one.

With an n-gram LM (`lm_fuse`, infer/lm_fusion.py or infer/lm_table.py)
neither K2 nor K9 runs, as in JAX (las_decoder.py:291,357): free running
and teacher forced alike, the step loop applies the head every step, fuses
its log-probs (on the card through the table fuser, or on a host copy
through the host fuser, the port's counterpart of JAX's pure_callback),
takes the greedy symbol of the fused log-probs and shifts it into the
LM context. Teacher forced, a step's input is [embedding of the reference
symbol ; cell], as JAX's scan body builds it, not the hoisted `pre0`.

Under bf16 params the LAS head's input is cast to its weight's dtype and
the picked log-softmax is reduced in f32 (las_decoder.py:411-447).

Under a kernel mesh K2 and K9 run per data shard (parallel/spmd.py
las_greedy_flash_dp, las_tf_scan_dp); K9's dropout masks are drawn for
the whole batch and cut there, so a shard's masks are the unsharded
step's rows.
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
from stjep_tpu_torch.ops.las_flash import las_flash_supported
from stjep_tpu_torch.ops.las_tf_flash import las_tf_flash_supported
from stjep_tpu_torch.ops.lstm import lstm_cell_step, lstm_gates, lstm_init
from stjep_tpu_torch.ops.masks import round_up8
from stjep_tpu_torch.ops.transformer import dropout, split, uniform
from stjep_tpu_torch.parallel.spmd import las_greedy_flash_dp, las_tf_scan_dp


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup with padding_idx=PAD semantics: the PAD row reads 0."""
    return table[ids.long()] * (ids != PAD)[..., None].to(table.dtype)


def embedding_init(generator: torch.Generator, vocab_size: int, dim: int,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """torch nn.Embedding default init: N(0, 1), PAD row zeroed."""
    t = torch.randn((vocab_size, dim), generator=generator)
    t[PAD] = 0.0
    return t.to(device, dtype)


def las_decoder_init(generator: torch.Generator, cfg: ModelConfig,
                     device=None, dtype=torch.float32) -> Dict:
    E, Ha, Hd = cfg.enc_embedding_size, cfg.acous_hidden_size, cfg.dim_model
    Hs = cfg.dim_model
    params: Dict = {
        "embedder": embedding_init(generator, cfg.enc_vocab_size, E, device, dtype),
        "acous_att": attention_init(generator, query_size=Hd, key_size=2 * Ha,
                                    mode=cfg.acous_att_mode, device=device, dtype=dtype),
        "acous_ffn": linear_init(generator, 2 * Ha + Hd, Hs, bias=False, device=device,
                                 dtype=dtype),
        "acous_out": linear_init(generator, Hs, cfg.enc_vocab_size, device=device,
                                 dtype=dtype),
        "dec_l0": lstm_init(generator, E + Hs, Hd, device, dtype),
    }
    for i in range(1, cfg.num_unilstm_dec):
        params[f"dec_l{i}"] = lstm_init(generator, Hd, Hd, device, dtype)
    return params


def lengths_from_preds(preds: torch.Tensor, L: int) -> torch.Tensor:
    """First emission of EOS or PAD at step j gives length j + 1, else L
    (ref: Dec.py:334-341)."""
    eos = (preds == EOS) | (preds == PAD)
    first = torch.argmax(eos.int(), dim=1)
    return torch.where(eos.any(dim=1), first + 1, torch.full_like(first, L))


def _make_drop_masks(generator: torch.Generator, cfg: ModelConfig,
                     n_steps: int, B: int, Ha2: int, device, dtype=torch.float32):
    """Inverted-dropout masks for every step of the decode loop, in two
    draws: (lstm [L-1, n, B, Hd], ctx [L-1, B, 1, Ha2]), in `dtype` (the
    activations': torch does not promote a bf16 stream through f32 masks
    into its matmuls as JAX does)."""
    keep = 1.0 - cfg.dropout
    shapes = (((n_steps, cfg.num_unilstm_dec, B, cfg.dim_model), 2), ((n_steps, B, 1, Ha2), 1))
    return tuple(((uniform(g, shape, device, batch_dim=bd) < keep).float() / keep).to(dtype)
                 for g, (shape, bd) in zip(split(generator), shapes))


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


def _fuse(lm_fuse, logp: torch.Tensor, ctx: torch.Tensor, step: int) -> torch.Tensor:
    """One step's LM fusion (las_decoder.py:476-490): the table fuser on the
    log-probs' device, or the host fuser on a host copy (JAX's
    pure_callback), its result moved back."""
    if getattr(lm_fuse, "on_device", False):
        return lm_fuse(logp, ctx, step)
    out = lm_fuse(logp.detach().float().cpu().numpy(), ctx.cpu().numpy(), step)
    return torch.from_numpy(out).to(device=logp.device, dtype=logp.dtype)


def _step_loop(params: Dict, cfg: ModelConfig, acous_outputs: torch.Tensor,
               att_mask: Optional[torch.Tensor], n_steps: int,
               pre0_steps: Optional[torch.Tensor] = None,
               sym0: Optional[torch.Tensor] = None, masks=None,
               ref_tokens: Optional[torch.Tensor] = None,
               pre_keys: Optional[Dict] = None, mode: Optional[str] = None,
               emb_steps: Optional[torch.Tensor] = None, lm_fuse=None,
               want_logps: bool = False):
    """JAX's scan of `las_decoder_step_core` (las_decoder.py:136-183,
    398-408, 454-504) in plain PyTorch, differentiable. Teacher forced with
    pre0_steps [n, B, 4Hd] and no head: returns the dynamic embeddings
    [n, B, Hs]. Otherwise the head runs every step and it returns (embs
    [B, n, Hs], greedy symbols [B, n], the log-softmax at ref_tokens[:, step]
    [B, n] (with want_logps and no refs, every log-prob [B, n, V]; else
    token 0's)). A step's symbol input is the previous greedy symbol,
    from sym0 [B], or with emb_steps [n, B, E] the given embeddings (teacher
    forcing under an LM). lm_fuse fuses each step's log-probs before the
    greedy pick, with the last 3 symbols as its context.
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
    ctx_lm = torch.zeros((B, 3), dtype=torch.int32, device=acous_outputs.device)
    sym = sym0
    embs, syms, picked = [], [], []
    for step in range(n_steps):
        m_lstm, m_ctx = (None, None) if masks is None else (masks[0][step], masks[1][step])
        if pre0_steps is not None:
            dec_out, h, c = _dec_lstm_stack(params, cfg, cell, h, c, m_lstm, pre0=pre0_steps[step])
        else:
            emb = embed(params["embedder"], sym) if emb_steps is None else emb_steps[step]
            dec_out, h, c = _dec_lstm_stack(params, cfg, torch.cat([emb, cell], dim=-1),
                                            h, c, m_lstm)
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
            if lm_fuse is not None:
                logp = _fuse(lm_fuse, logp, ctx_lm, step)
            sym = torch.argmax(logp, dim=-1)
            syms.append(sym)
            if lm_fuse is not None:
                ctx_lm = torch.cat([ctx_lm[:, 1:], sym[:, None].to(torch.int32)], dim=1)
            if want_logps and ref_tokens is None:
                picked.append(logp)
                continue
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
                    ref_tokens: Optional[torch.Tensor], want_logps: bool = True):
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
        masks = _make_drop_masks(k, cfg, L - 1, B, Ha2, acous_outputs.device,
                                 acous_outputs.dtype)
    p0 = params["dec_l0"]
    E = params["embedder"].shape[1]
    emb_steps = emb_tgt[:, :L - 1].transpose(0, 1)  # [L-1, B, E]
    pre0 = emb_steps @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]
    if cfg.num_unilstm_dec == 3 and las_tf_flash_supported(cfg):
        stack = {k: params[k] for k in ("dec_l0", "dec_l1", "dec_l2")}
        embs = las_tf_scan_dp(stack, params["acous_att"]["linear_att_w"]["w"],
                              params["acous_ffn"]["w"], pre0, acous_outputs, lens_k,
                              masks)
    else:
        embs = _step_loop(params, cfg, acous_outputs, _att_mask(lens_k, acous_outputs.shape[1]),
                          L - 1, pre0_steps=pre0, masks=masks)
    embs = embs.transpose(0, 1)  # [B, L-1, Hs]
    head_w = params["acous_out"]["w"]
    # the training NLL path feeds the head in its weight's dtype (bf16 under
    # --dtype bfloat16; a no-op at f32) (las_decoder.py:411-420)
    head_in = embs.to(head_w.dtype) if ref_tokens is not None else embs
    logits = linear(params["acous_out"], head_in)
    symbols = torch.argmax(logits, dim=-1)  # == argmax of the log-softmax
    lengths = lengths_from_preds(symbols, L)
    if ref_tokens is None:
        return embs, torch.log_softmax(logits, dim=-1) if want_logps else None, symbols, lengths
    # the log-softmax at the reference token, by gather minus logsumexp, in
    # f32 (las_decoder.py:432-447)
    ids = ref_tokens[:, :L - 1].long()[..., None]
    lf = logits.float()
    picked = lf.gather(-1, ids)[..., 0] - torch.logsumexp(lf, dim=-1)
    return embs, picked, symbols, lengths


def las_decoder_forward(params: Dict, cfg: ModelConfig,
                        acous_outputs: torch.Tensor,
                        acous_lens: Optional[torch.Tensor] = None,
                        max_seq_len: Optional[int] = None,
                        tgt: Optional[torch.Tensor] = None,
                        use_teacher_forcing: bool = False,
                        generator: Optional[torch.Generator] = None,
                        is_training: bool = False,
                        ref_tokens: Optional[torch.Tensor] = None,
                        teacher_forcing_ratio: Optional[float] = None,
                        flash_ok: bool = True, lm_fuse=None, want_logps: bool = True,
                        dense_logps: bool = False):
    """Free running: greedy decode over max_seq_len - 1 steps (tgt.shape[1]
    - 1 from tgt[:, 0] when tgt is given), returning
    (sequence_embs [B, L-1, Hs], None, symbols [B, L-1], lengths [B]), the
    JAX function's return with want_logps=False; with ref_tokens, the
    second entry is the picked log-probs [B, L-1] at ref_tokens[:, :L-1]
    (PAD-padded to L-1, as las_decoder.py:308-312 pads them). Teacher-forced
    on tgt [B, L]: (sequence_embs, logps [B, L-1, V] or, with ref_tokens,
    the picked log-probs [B, L-1] at ref_tokens[:, :L-1], symbols,
    lengths); want_logps=False drops the [B, L-1, V] log-probs (None in
    their slot), as JAX's flag does.

    teacher_forcing_ratio, when given, is the reference's per-batch coin
    `random.random() < ratio` (ref: Dec.py:196): >= 1.0 teacher-forced,
    <= 0.0 free running, anything between one draw from `generator` (JAX
    draws a traced bernoulli, las_decoder.py:256-266). The free-running
    loop runs K2 when flash_ok and not is_training (the JAX gate,
    las_decoder.py:288-292), else the differentiable step loop with the
    training dropout masks. lm_fuse (a fuser of infer/lm_fusion.py or
    infer/lm_table.py) runs both branches through the step loop, its
    log-probs, symbols and lengths those of the fused log-probs.
    dense_logps: free running without ref_tokens, the second entry is
    every step's log-probs [B, L-1, V] (JAX's want_logps there, its XLA
    scan): the step loop runs, since K2 emits none."""
    B, Tk, _ = acous_outputs.shape
    if acous_lens is not None:
        lens_k = round_up8(acous_lens.long()) // 8  # ref: Dec.py:173-179
    else:
        lens_k = torch.full((B,), Tk, dtype=torch.int64, device=acous_outputs.device)
    if teacher_forcing_ratio is not None:
        if tgt is None:
            raise ValueError("stochastic teacher forcing needs tgt")  # ref: Las.py:107
        if 0.0 < teacher_forcing_ratio < 1.0:
            generator, k = split(generator)
            use_teacher_forcing = bool(
                torch.rand((), generator=k) < teacher_forcing_ratio)
        else:
            use_teacher_forcing = teacher_forcing_ratio >= 1.0
    if use_teacher_forcing and tgt is None:
        raise ValueError("teacher forcing needs tgt")
    if use_teacher_forcing and lm_fuse is None:
        return _teacher_forced(params, cfg, acous_outputs, lens_k, tgt,
                               generator, is_training, ref_tokens, want_logps)
    dev = acous_outputs.device
    if tgt is not None:
        L, sym0 = tgt.shape[1], tgt[:, 0].long()
    else:
        L = max_seq_len if max_seq_len is not None else cfg.max_seq_len_src
        sym0 = torch.full((B,), BOS, dtype=torch.int64, device=dev)
    refs = None
    if ref_tokens is not None:  # K2 reads them as contiguous [B, L-1] int32
        r = ref_tokens[:, :L - 1].to(torch.int32)
        refs = F.pad(r, (0, L - 1 - r.shape[1]), value=PAD).contiguous()
    dense_logps = dense_logps and refs is None and not use_teacher_forcing
    if (flash_ok and not is_training and not use_teacher_forcing and lm_fuse is None
            and not dense_logps and las_flash_supported(cfg)):
        pre_keys = precompute_keys(params["acous_att"], acous_outputs, cfg.acous_att_mode)
        embs, preds, picked = las_greedy_flash_dp(params, cfg, pre_keys["wk"],
                                                  acous_outputs, lens_k, sym0, L - 1,
                                                  ref_tokens=refs)
    else:
        emb_steps = None
        if use_teacher_forcing:  # under an LM: JAX's scan body (las_decoder.py:454-504)
            emb_tgt = embed(params["embedder"], tgt)
            if is_training and cfg.embedding_dropout > 0.0:  # ref: Dec.py:166
                generator, k = split(generator)
                emb_tgt = dropout(k, emb_tgt, cfg.embedding_dropout, True)
            emb_steps = emb_tgt[:, :L - 1].transpose(0, 1)
        masks = None
        if is_training and cfg.dropout > 0.0:
            generator, k = split(generator)
            masks = _make_drop_masks(k, cfg, L - 1, B, acous_outputs.shape[-1], dev,
                                     acous_outputs.dtype)
        embs, preds, picked = _step_loop(params, cfg, acous_outputs, _att_mask(lens_k, Tk),
                                         L - 1, sym0=sym0, masks=masks, ref_tokens=refs,
                                         emb_steps=emb_steps, lm_fuse=lm_fuse,
                                         want_logps=(use_teacher_forcing and want_logps)
                                         or dense_logps)
    second = (picked if refs is not None or (use_teacher_forcing and want_logps)
              or dense_logps else None)
    return embs, second, preds, lengths_from_preds(preds, L)
