"""Linear layers and the bilinear RNN-decoder attention (port of
stjep_tpu/ops/attention.py, bilinear mode only).

Weights keep the JAX `[in, out]` layout: `linear(p, x) = x @ p["w"] + p["b"]`.
The dot_prod, bahdanau and hybrid score modes are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

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


def _check_mode(mode: str):
    if mode != "bilinear":
        raise NotImplementedError(
            f"attention mode {mode!r} is not ported yet (ROADMAP Queue A)")


def attention_init(generator: torch.Generator, query_size: int, key_size: int,
                   mode: str = "bilinear", device=None) -> Dict:
    _check_mode(mode)
    return {"linear_att_w": linear_init(generator, key_size, query_size,
                                        bias=False, device=device)}


def precompute_keys(params: Dict, keys: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """Key-side projection hoisted out of the decode loop: [B, Tk, Hq]."""
    _check_mode(mode)
    return {"wk": linear(params["linear_att_w"], keys)}


def calc_score(params: Dict, pre: Dict[str, torch.Tensor], query: torch.Tensor,
               mode: str) -> torch.Tensor:
    """Scores [B, Tq, Tk] = query [B, Tq, Hq] . wk [B, Tk, Hq]."""
    _check_mode(mode)
    return torch.einsum("bqh,bkh->bqk", query, pre["wk"])


def attend(params: Dict, pre: Dict[str, torch.Tensor], query: torch.Tensor,
           values: torch.Tensor, mode: str,
           mask: Optional[torch.Tensor] = None):
    """scores -> -1e12 where mask ([B, Tk], True = masked out) -> softmax ->
    weighted values. Returns (context [B, Tq, Dv], attn [B, Tq, Tk])."""
    scores = calc_score(params, pre, query, mode)
    if mask is not None:
        scores = torch.where(mask[:, None, :], torch.full_like(scores, MASK_FILL),
                             scores)
    attn = torch.softmax(scores, dim=2)
    return torch.einsum("bqk,bkv->bqv", attn, values), attn
