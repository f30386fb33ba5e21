"""LAS attention decoder, free-running branch (port of
stjep_tpu/models/las_decoder.py).

Each step feeds [embedding of the previous symbol ; previous dynamic
embedding] through a 3-layer residual uni-LSTM, attends bilinearly over the
pyramid output, and emits the dynamic embedding FFN([context ; query]) and
a greedy symbol (ref: models/Dec.py:344-438). The whole loop runs through
K2 (`ops/las_flash.py`). Teacher forcing, hybrid attention and LM fusion
are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch.config import BOS, EOS, PAD, ModelConfig
from stjep_tpu_torch.ops.attention import attention_init, linear_init, precompute_keys
from stjep_tpu_torch.ops.las_flash import las_greedy_flash
from stjep_tpu_torch.ops.lstm import lstm_init
from stjep_tpu_torch.ops.masks import round_up8


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


def las_decoder_forward(params: Dict, cfg: ModelConfig,
                        acous_outputs: torch.Tensor,
                        acous_lens: Optional[torch.Tensor] = None,
                        max_seq_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, None, torch.Tensor, torch.Tensor]:
    """Free-running greedy decode over max_seq_len - 1 steps. Returns
    (sequence_embs [B, L-1, Hs], None, symbols [B, L-1], lengths [B]) —
    the JAX function's return with want_logps=False."""
    B, Tk, _ = acous_outputs.shape
    L = max_seq_len if max_seq_len is not None else cfg.max_seq_len_src
    if acous_lens is not None:
        lens_k = round_up8(acous_lens.long()) // 8  # ref: Dec.py:173-179
    else:
        lens_k = torch.full((B,), Tk, dtype=torch.int64, device=acous_outputs.device)
    pre_keys = precompute_keys(params["acous_att"], acous_outputs, cfg.acous_att_mode)
    sym0 = torch.full((B,), BOS, dtype=torch.int64, device=acous_outputs.device)
    embs, preds, _ = las_greedy_flash(params, cfg, pre_keys["wk"], acous_outputs,
                                      lens_k, sym0, L - 1)
    return embs, None, preds, lengths_from_preds(preds, L)
