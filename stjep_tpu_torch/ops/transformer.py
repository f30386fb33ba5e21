"""Transformer building blocks, pre-LN and batch-first (port of
stjep_tpu/ops/transformer.py).

Reference quirks kept for checkpoint parity (ref: modules/layers.py):
LayerNorm on the query input only, keys/values projected from the raw
inputs; -1e9 fill where mask == 0, on an einsum softmax (torch's SDPA
returns NaN on fully masked rows); eps 1e-6; FFN LN -> w1 -> relu -> w2 ->
dropout -> +residual; attention-probability dropout fixed at 0.1 whatever
the configured rate.

Randomness: a JAX key becomes a host `torch.Generator` on the CPU, and
`split` stands where the JAX code calls `jax.random.split`, so the places
where randomness is drawn correspond one to one (the streams differ). A
draw for a CUDA tensor uses a generator on the tensor's device, seeded
from the host generator, so no draw waits for the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from stjep_tpu_torch.ops.attention import linear, linear_init

ATTN_MASK_FILL = -1e9  # ref: modules/layers.py:224
ATTN_DROPOUT = 0.1  # ref: modules/layers.py:207


def split(generator: Optional[torch.Generator], n: int = 2) -> List:
    """n independent host generators seeded from `generator` (None -> n
    Nones): the counterpart of jax.random.split."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def on_device(generator: torch.Generator, device) -> torch.Generator:
    """A generator on `device` for a draw there: the host generator itself
    on the CPU, else a device generator seeded from it."""
    if torch.device(device).type == "cpu":
        return generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            training: bool) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate and scale by
    1 / (1 - rate), as `jnp.where(mask, x / keep, 0)`."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=on_device(generator, x.device),
                   device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


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
                         mask: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         training: bool = False) -> torch.Tensor:
    """q, k, v [B, L, n, d]; mask broadcastable to [B, 1, Lq, Lk] with
    0 = blocked. Returns [B, Lq, n, d]."""
    attn = torch.einsum("bqnd,bknd->bnqk", q / temperature, k)
    if mask is not None:
        attn = attn.masked_fill(mask == 0, ATTN_MASK_FILL)
    attn = torch.softmax(attn, dim=-1)
    attn = dropout(generator, attn, ATTN_DROPOUT, training)
    return torch.einsum("bnqk,bknd->bqnd", attn, v)


def mha(params: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        n_head: int, mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, dropout_rate: float = 0.0,
        training: bool = False) -> torch.Tensor:
    """Multi-head attention with the residual; mask [B, Lq|1, Lk]."""
    d_k = params["w_qs"]["w"].shape[1] // n_head
    qn = layer_norm(params["layer_norm"], q, eps=1e-6)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], n_head, -1)

    r1, r2 = split(generator)
    out = scaled_dot_attention(
        heads(linear(params["w_qs"], qn)), heads(linear(params["w_ks"], k)),
        heads(linear(params["w_vs"], v)), d_k ** 0.5,
        mask=mask[:, None] if mask is not None else None, generator=r1,
        training=training)
    out = linear(params["fc"], out.reshape(out.shape[0], out.shape[1], -1))
    return dropout(r2, out, dropout_rate, training) + q


def ffn_init(generator: torch.Generator, d_in: int, d_hid: int, device=None) -> Dict:
    return {"w_1": linear_init(generator, d_in, d_hid, device=device),
            "w_2": linear_init(generator, d_hid, d_in, device=device),
            "layer_norm": layer_norm_init(d_in, device)}


def ffn(params: Dict, x: torch.Tensor, generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0, training: bool = False) -> torch.Tensor:
    y = layer_norm(params["layer_norm"], x, eps=1e-6)
    y = linear(params["w_2"], torch.relu(linear(params["w_1"], y)))
    return dropout(generator, y, dropout_rate, training) + x


def encoder_layer_init(generator: torch.Generator, d_model: int, n_head: int,
                       d_ff: int, device=None) -> Dict:
    d_k = d_model // n_head
    return {"slf_attn": mha_init(generator, n_head, d_model, d_k, d_k, device),
            "pos_ffn": ffn_init(generator, d_model, d_ff, device)}


def encoder_layer(params: Dict, x: torch.Tensor, n_head: int,
                  mask: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  dropout_rate: float = 0.0, training: bool = False) -> torch.Tensor:
    r1, r2 = split(generator)
    y = mha(params["slf_attn"], x, x, x, n_head, mask, generator=r1,
            dropout_rate=dropout_rate, training=training)
    return ffn(params["pos_ffn"], y, generator=r2, dropout_rate=dropout_rate,
               training=training)


def decoder_layer_init(generator: torch.Generator, d_model: int, n_head: int,
                       d_ff: int, device=None) -> Dict:
    d_k = d_model // n_head
    return {"decslf_attn": mha_init(generator, n_head, d_model, d_k, d_k, device),
            "encdec_attn": mha_init(generator, n_head, d_model, d_k, d_k, device),
            "pos_ffn": ffn_init(generator, d_model, d_ff, device)}


def decoder_layer(params: Dict, x: torch.Tensor, memory: torch.Tensor,
                  n_head: int, self_mask: Optional[torch.Tensor] = None,
                  cross_mask: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  dropout_rate: float = 0.0, training: bool = False) -> torch.Tensor:
    """Self-attention, cross-attention over `memory`, FFN
    (ref: modules/layers.py:66-112)."""
    r1, r2, r3 = split(generator, 3)
    y = mha(params["decslf_attn"], x, x, x, n_head, self_mask, generator=r1,
            dropout_rate=dropout_rate, training=training)
    y = mha(params["encdec_attn"], y, memory, memory, n_head, cross_mask,
            generator=r2, dropout_rate=dropout_rate, training=training)
    return ffn(params["pos_ffn"], y, generator=r3, dropout_rate=dropout_rate,
               training=training)
