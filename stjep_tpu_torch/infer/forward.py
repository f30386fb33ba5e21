"""forward_translate / forward_translate_refen: beam-search inference in
every translate mode (port of stjep_tpu/infer/forward.py), and
`forward_eval`, the dev eval with reference ids (defined in
models/seq2seq.py as in the JAX package, exported here beside the other
eval entry point).

Modes (ref: Seq2seq.py:641-903):
- ASR: the LAS hypotheses (greedy; beam search not used).
- ST: the LAS free-running pass gives dynamic embeddings and ASR
  hypotheses; their static embeddings and the dynamic ones pass through
  `enc_emb_proj` into the transformer encoder, masked by the LAS lengths,
  and the transformer (standard, universal, or universal with ACT)
  decodes by beam search; an ACT decoder re-runs its token buffer each
  position (infer/beam.py), at beam width 1 too, where JAX's CPU route
  runs its dense greedy: width 1 keeps the argmax, so both emit the same
  tokens.
- MT: the average dynamic embedding (`params["emb_dyn_ave"]`, translate
  mode 3's artifact) broadcast over the source, beam decode.
- ST_BASE: the LAS hypotheses with the average dynamic embedding
  (pre-finetune decode, ref: Seq2seq.py:741-794).
With refen (`forward_translate_refen`), the LAS is teacher-forced on the
reference source (K9's forward on the card, no backward under no_grad) and
ST takes the reference's static embeddings (ref: Seq2seq.py:799-903).
`lm_fuse` (infer/lm_fusion.py, infer/lm_table.py) fuses an n-gram LM into
every LAS pass, free running and teacher forced, as the reference threads
its LM into each (ST :702, ST_BASE :752, refen :816, :863); the LAS then
runs the step loop, not K2 or K9, as in JAX. The eval entry points draw no
random numbers and run under torch.no_grad(): their kernels (K1-K5, K7,
K9's forward) have no backward there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.bridge import check_params_device
from stjep_tpu_torch.config import ModelConfig
from stjep_tpu_torch.infer.beam import beam_search
from stjep_tpu_torch.models.seq2seq import (
    _encoder_acous,
    _encoder_en,
    _get_src_emb,
    _length_src_mask,
    _pre_proc_src,
    _src_emb_ave,
    forward_eval,
)
from stjep_tpu_torch.utils.profiling import span

__all__ = ["forward_eval", "forward_translate", "forward_translate_refen"]


def _emb_dyn_ave(params: Dict, cfg: ModelConfig, B: int, L: int) -> torch.Tensor:
    """The average dynamic embedding broadcast to [B, L, D]."""
    return params["emb_dyn_ave"][None, None, :].expand(B, L, cfg.dim_model)


def _las_pass(params, cfg, acous_feats, acous_lens, src, refen, lm_fuse):
    """The LAS pass of an acoustic mode: teacher-forced on the reference
    source with refen, else free running over cfg.max_seq_len_src - 1
    steps. Returns (dynamic embs, symbols, lengths)."""
    with span("stjep.decode.las"):
        if refen:
            emb, _, preds, lengths = _encoder_acous(params, cfg, acous_feats, acous_lens,
                                                    tgt=src, teacher_forcing=True,
                                                    lm_fuse=lm_fuse, want_logps=False)
        else:
            emb, _, preds, lengths = _encoder_acous(params, cfg, acous_feats, acous_lens,
                                                    max_seq_len=cfg.max_seq_len_src,
                                                    lm_fuse=lm_fuse)
    return emb, preds, lengths


def _encode_for_mode(params: Dict, cfg: ModelConfig, mode: str, src, acous_feats,
                     acous_lens, refen: bool, lm_fuse=None):
    """Encoder memory [B, Ls, D] and its mask [B, Ls] for each translate
    mode (stjep_tpu/infer/forward.py:31-85)."""
    if mode == "ST":
        emb_dyn, preds_src, lengths = _las_pass(params, cfg, acous_feats, acous_lens,
                                                src, refen, lm_fuse)
        # static embeddings of the reference with refen (ref:
        # Seq2seq.py:861-865), else of the hypotheses (:703)
        static_ids = _pre_proc_src(src) if refen else preds_src
    elif mode == "ST_BASE":
        _, static_ids, lengths = _las_pass(params, cfg, acous_feats, acous_lens, None,
                                           False, lm_fuse)
        emb_dyn = _emb_dyn_ave(params, cfg, *static_ids.shape)
    elif mode != "MT":
        raise ValueError(f"unknown translate mode {mode}")
    with span("stjep.decode.encoder"):
        if mode == "MT":
            _, emb_src, src_mask_input = _src_emb_ave(params, cfg, src)
        else:
            _, emb_src, _ = _get_src_emb(params, cfg, static_ids, emb_dyn)
            src_mask_input = _length_src_mask(lengths, emb_src.shape[1])
        enc_out = _encoder_en(params, cfg, emb_src, src_mask=src_mask_input)
    return enc_out, src_mask_input[:, 0, :]


@torch.no_grad()
def forward_translate(params: Dict, cfg: ModelConfig, mode: str,
                      acous_feats: Optional[torch.Tensor] = None,
                      acous_lens: Optional[torch.Tensor] = None,
                      beam_width: int = 1, penalty_factor: float = 1.0,
                      max_seq_len: int = 900, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      cache_dtype: Optional[torch.dtype] = None,
                      weight_dtype: Optional[str] = None,
                      src: Optional[torch.Tensor] = None, refen: bool = False,
                      lm_fuse=None) -> torch.Tensor:
    """Modes ST, MT, ST_BASE: [B, max_seq_len] best-beam tokens, BOS first,
    PAD-padded. ASR: [B, max_seq_len_src - 1] LAS tokens (with refen
    teacher-forced on src: [B, src.shape[1] - 1]). Beam width 1 runs the
    beam path at width 1, which emits the greedy sequence. An unknown mode
    raises ValueError.

    src [B, Ls] (BOS first): the source ids MT encodes and the refen modes
    feed the LAS. refen: the reference-history modes (ASR-REF, ST-REF).
    lm_fuse: an n-gram LM fuser for every LAS pass (module docstring).
    `device`: where the call runs, the card unless the caller asks for the
    CPU (the plain routes); the inputs move there, and params must already
    lie there (ValueError otherwise). `cache_dtype` (torch.bfloat16) and
    `weight_dtype` ("int8") are the serving options of the transformer beam
    (infer/beam.py); ASR has no weight-streaming mode and raises on a
    weight_dtype, as the JAX function does. `generator` stands for the JAX
    function's `rng`: eval draws no random numbers, so it is not read.

    Under a kernel mesh (parallel/spmd.py `set_kernel_mesh`) the beam
    decodes per data shard and, with a model axis, tensor-parallel, e.g.
    on one card: set_kernel_mesh(make_mesh(1, 4, ["cuda"] * 4)). The
    encoder runs the whole batch where the call runs.

    The call is the span `stjep.decode`, its LAS pass `stjep.decode.las`
    and its encoder `stjep.decode.encoder` (utils/profiling.py `span`)."""
    if mode == "ASR" and weight_dtype is not None:
        raise ValueError(
            f"weight_dtype={weight_dtype!r} only applies to the transformer "
            "beam decode; ASR (LAS greedy) has no weight-streaming mode")
    with span("stjep.decode"):
        device = check_params_device(params, device)
        acous_feats, acous_lens, src = (t if t is None else t.to(device)
                                        for t in (acous_feats, acous_lens, src))
        if mode == "ASR":
            # the reference LM-fuses even the teacher-forced refen pass:
            # emitted symbols are fused though inputs come from the
            # reference history (ref: Seq2seq.py:816)
            return _las_pass(params, cfg, acous_feats, acous_lens, src, refen, lm_fuse)[1]
        enc_out, mem_mask_b = _encode_for_mode(params, cfg, mode, src, acous_feats,
                                               acous_lens, refen, lm_fuse)
        preds, _ = beam_search(params, cfg, enc_out, mem_mask_b, max(1, beam_width),
                               penalty_factor, max_seq_len, cache_dtype=cache_dtype,
                               weight_dtype=weight_dtype)
        return preds


def forward_translate_refen(params: Dict, cfg: ModelConfig, mode: str, **kw) -> torch.Tensor:
    """forward_translate with the reference source history (ref:
    Seq2seq.py:799-903)."""
    return forward_translate(params, cfg, mode, refen=True, **kw)
