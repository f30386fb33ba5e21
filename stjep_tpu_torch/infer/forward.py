"""forward_translate: beam-search inference (port of
stjep_tpu/infer/forward.py, modes ST and ASR), and `forward_eval`, the dev
eval with reference ids (defined in models/seq2seq.py as in the JAX
package, exported here beside the other eval entry point).

ST: the LAS free-running pass gives dynamic embeddings and ASR hypotheses;
their static embeddings and the dynamic ones pass through `enc_emb_proj`
into the transformer encoder, masked by the LAS lengths, and the
transformer (standard or universal) decodes by beam search (ref:
Seq2seq.py:641-796). ASR returns the LAS hypotheses. The eval entry points
draw no random numbers and run under torch.no_grad(): their kernels (K1-K5,
K7) have no backward.
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
    forward_eval,
)

__all__ = ["encode_st", "forward_eval", "forward_translate"]


def encode_st(params: Dict, cfg: ModelConfig, acous_feats: torch.Tensor,
              acous_lens: Optional[torch.Tensor]):
    """ST encoder memory: (enc_out [B, L-1, D], mem_mask [B, L-1] bool,
    ASR hypotheses [B, L-1]) with L = cfg.max_seq_len_src."""
    emb_dyn, _, preds_src, lengths = _encoder_acous(
        params, cfg, acous_feats, acous_lens, max_seq_len=cfg.max_seq_len_src)
    _, emb_src, _ = _get_src_emb(params, cfg, preds_src, emb_dyn)
    src_mask = _length_src_mask(lengths, emb_src.shape[1])
    return _encoder_en(params, cfg, emb_src, src_mask=src_mask), src_mask[:, 0, :], preds_src


@torch.no_grad()
def forward_translate(params: Dict, cfg: ModelConfig, mode: str,
                      acous_feats: Optional[torch.Tensor] = None,
                      acous_lens: Optional[torch.Tensor] = None,
                      beam_width: int = 1, penalty_factor: float = 1.0,
                      max_seq_len: int = 900, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      cache_dtype: Optional[torch.dtype] = None,
                      weight_dtype: Optional[str] = None) -> torch.Tensor:
    """ST: [B, max_seq_len] best-beam tokens, BOS first, PAD-padded.
    ASR: [B, max_seq_len_src - 1] LAS tokens. Beam width 1 runs the beam
    path at width 1, which emits the greedy sequence.

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
    encoder runs the whole batch where the call runs."""
    if mode == "ASR" and weight_dtype is not None:
        raise ValueError(
            f"weight_dtype={weight_dtype!r} only applies to the transformer "
            "beam decode; ASR (LAS greedy) has no weight-streaming mode")
    device = check_params_device(params, device)
    acous_feats = acous_feats.to(device)
    if acous_lens is not None:
        acous_lens = acous_lens.to(device)
    if mode == "ASR":
        return _encoder_acous(params, cfg, acous_feats, acous_lens,
                              max_seq_len=cfg.max_seq_len_src)[2]
    if mode != "ST":
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (MT, ST_BASE, refen and LM "
            "fusion: ROADMAP Queue A, slice 3)")
    enc_out, mem_mask_b, _ = encode_st(params, cfg, acous_feats, acous_lens)
    preds, _ = beam_search(params, cfg, enc_out, mem_mask_b, max(1, beam_width),
                           penalty_factor, max_seq_len, cache_dtype=cache_dtype,
                           weight_dtype=weight_dtype)
    return preds
