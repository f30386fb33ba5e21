"""Linear layers and the RNN-decoder attention (port of
stjep_tpu/ops/attention.py) with its four score modes:

- 'bilinear'  score = q @ (W k)^T
- 'dot_prod'  score = q @ k^T
- 'bahdanau'  score = w^T tanh(U q + V k + b)
- 'hybrid'    a * exp(-b (c - j)^2), c a cumulative mean

Weights keep the JAX `[in, out]` layout: `linear(p, x) = x @ p["w"] + p["b"]`.
Plain PyTorch: the LAS kernels (K2, K9) take bilinear attention only, and
the decoder dispatches the other modes to its step loop
(models/las_decoder.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

MASK_FILL = -1e12  # ref: modules/attention.py:252


def _uniform(generator: torch.Generator, shape, bound: float, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * bound) - bound).to(device)


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True, device=None) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear's default init in `[in, out]` layout."""
    p = {"w": _uniform(generator, (in_dim, out_dim),
                       math.sqrt(1.0 / in_dim) * math.sqrt(3.0), device)}
    if bias:
        p["b"] = _uniform(generator, (out_dim,), 1.0 / math.sqrt(in_dim), device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def attention_init(generator: torch.Generator, query_size: int, key_size: int,
                   mode: str = "bilinear", hidden_size: int = 1, device=None) -> Dict:
    """Parameters of one AttentionLayer in the JAX package's tree layout
    (stjep_tpu/ops/attention.py `attention_init`)."""
    if mode == "bilinear":
        return {"linear_att_w": linear_init(generator, key_size, query_size,
                                            bias=False, device=device)}
    if mode == "dot_prod":
        return {}
    if mode == "bahdanau":
        return {"linear_att_q": linear_init(generator, query_size, hidden_size, device=device),
                "linear_att_k": linear_init(generator, key_size, hidden_size, device=device),
                "linear_att_o": linear_init(generator, hidden_size, 1, device=device)}
    if mode == "hybrid":
        p = {}
        for n in ("a", "b", "c"):
            p[f"linear_att_{n}q"] = linear_init(generator, query_size, hidden_size, device=device)
            p[f"linear_att_{n}k"] = linear_init(generator, key_size, hidden_size, device=device)
            p[f"linear_att_{n}o"] = linear_init(generator, hidden_size, 1, device=device)
        return p
    raise ValueError(f"unknown attention mode {mode}")


def precompute_keys(params: Dict, keys: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """Key-side projections hoisted out of the decode loop."""
    if mode == "bilinear":
        return {"wk": linear(params["linear_att_w"], keys)}  # [B, Tk, Hq]
    if mode == "dot_prod":
        return {"wk": keys}
    if mode == "bahdanau":
        return {"uk": linear(params["linear_att_k"], keys)}  # [B, Tk, Hh]
    if mode == "hybrid":
        return {f"{n}_uk": linear(params[f"linear_att_{n}k"], keys) for n in ("a", "b", "c")}
    raise ValueError(f"unknown attention mode {mode}")


def _additive(params: Dict, tag: str, uk: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """w^T tanh(U q + V k + b): [B, Tq, Tk]."""
    wq = linear(params[f"linear_att_{tag}q"], query)
    s = torch.tanh(wq[:, :, None, :] + uk[:, None, :, :])  # [B, Tq, Tk, Hh]
    return linear(params[f"linear_att_{tag}o"], s)[..., 0]


def calc_score(params: Dict, pre: Dict[str, torch.Tensor], query: torch.Tensor,
               mode: str, prev_c: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(scores [B, Tq, Tk], c_out) from query [B, Tq, Hq] and the
    precomputed keys. c_out is hybrid's cumulative mean (None otherwise):
    carried across decode steps through prev_c when Tq == 1, a cumulative
    sum over the queries otherwise."""
    if mode in ("bilinear", "dot_prod"):
        return torch.einsum("bqh,bkh->bqk", query, pre["wk"]), None
    if mode == "bahdanau":
        return _additive(params, "", pre["uk"], query), None
    if mode == "hybrid":
        a_out, b_out, c_out = (torch.exp(_additive(params, t, pre[f"{t}_uk"], query))
                               for t in ("a", "b", "c"))
        key_idx = torch.arange(pre["a_uk"].shape[1], dtype=query.dtype,
                               device=query.device)[None, None, :]
        if query.shape[1] == 1:
            c_cum = (prev_c if prev_c is not None else 0.0) + c_out
        else:
            c_cum = torch.cumsum(c_out, dim=1)
        return a_out * torch.exp(-b_out * (c_cum - key_idx) ** 2), c_cum
    raise ValueError(f"unknown attention mode {mode}")


def attend(params: Dict, pre: Dict[str, torch.Tensor], query: torch.Tensor,
           values: torch.Tensor, mode: str,
           mask: Optional[torch.Tensor] = None,
           prev_c: Optional[torch.Tensor] = None):
    """scores -> -1e12 where mask ([B, Tk], True = masked out) -> softmax ->
    weighted values. Returns (context [B, Tq, Dv], attn [B, Tq, Tk], c_out)."""
    scores, c_out = calc_score(params, pre, query, mode, prev_c=prev_c)
    if mask is not None:
        scores = torch.where(mask[:, None, :], torch.full_like(scores, MASK_FILL),
                             scores)
    attn = torch.softmax(scores, dim=2)
    return torch.einsum("bqk,bkv->bqv", attn, values), attn, c_out
