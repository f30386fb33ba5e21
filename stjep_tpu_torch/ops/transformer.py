"""Transformer building blocks, pre-LN and batch-first (port of
stjep_tpu/ops/transformer.py, eval only).

Reference quirks kept for checkpoint parity (ref: modules/layers.py):
LayerNorm on the query input only, keys/values projected from the raw
inputs; -1e9 fill where mask == 0; eps 1e-6; FFN LN -> w1 -> relu -> w2 ->
+residual. Dropout is not ported (inference only).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.ops.attention import linear, linear_init

ATTN_MASK_FILL = -1e9  # ref: modules/layers.py:224


def layer_norm_init(dim: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def mha_init(generator: torch.Generator, n_head: int, d_model: int, d_k: int,
             d_v: int, device=None) -> Dict:
    return {
        "w_qs": linear_init(generator, d_model, n_head * d_k, bias=False, device=device),
        "w_ks": linear_init(generator, d_model, n_head * d_k, bias=False, device=device),
        "w_vs": linear_init(generator, d_model, n_head * d_v, bias=False, device=device),
        "fc": linear_init(generator, n_head * d_v, d_model, bias=False, device=device),
        "layer_norm": layer_norm_init(d_model, device),
    }


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         temperature: float,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, L, n, d]; mask broadcastable to [B, 1, Lq, Lk] with
    0 = blocked. Returns [B, Lq, n, d]."""
    attn = torch.einsum("bqnd,bknd->bnqk", q / temperature, k)
    if mask is not None:
        attn = attn.masked_fill(mask == 0, ATTN_MASK_FILL)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bnqk,bknd->bqnd", attn, v)


def mha(params: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        n_head: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention with the residual; mask [B, Lq|1, Lk]."""
    d_k = params["w_qs"]["w"].shape[1] // n_head
    qn = layer_norm(params["layer_norm"], q, eps=1e-6)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], n_head, -1)

    out = scaled_dot_attention(
        heads(linear(params["w_qs"], qn)), heads(linear(params["w_ks"], k)),
        heads(linear(params["w_vs"], v)), d_k ** 0.5,
        mask=mask[:, None] if mask is not None else None)
    return linear(params["fc"], out.reshape(out.shape[0], out.shape[1], -1)) + q


def ffn_init(generator: torch.Generator, d_in: int, d_hid: int, device=None) -> Dict:
    return {"w_1": linear_init(generator, d_in, d_hid, device=device),
            "w_2": linear_init(generator, d_hid, d_in, device=device),
            "layer_norm": layer_norm_init(d_in, device)}


def ffn(params: Dict, x: torch.Tensor) -> torch.Tensor:
    y = layer_norm(params["layer_norm"], x, eps=1e-6)
    return linear(params["w_2"], torch.relu(linear(params["w_1"], y))) + x


def encoder_layer_init(generator: torch.Generator, d_model: int, n_head: int,
                       d_ff: int, device=None) -> Dict:
    d_k = d_model // n_head
    return {"slf_attn": mha_init(generator, n_head, d_model, d_k, d_k, device),
            "pos_ffn": ffn_init(generator, d_model, d_ff, device)}


def encoder_layer(params: Dict, x: torch.Tensor, n_head: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return ffn(params["pos_ffn"], mha(params["slf_attn"], x, x, x, n_head, mask))


def decoder_layer_init(generator: torch.Generator, d_model: int, n_head: int,
                       d_ff: int, device=None) -> Dict:
    d_k = d_model // n_head
    return {"decslf_attn": mha_init(generator, n_head, d_model, d_k, d_k, device),
            "encdec_attn": mha_init(generator, n_head, d_model, d_k, d_k, device),
            "pos_ffn": ffn_init(generator, d_model, d_ff, device)}
