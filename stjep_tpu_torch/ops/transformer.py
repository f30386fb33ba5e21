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
from the host generator, so no draw waits for the device. Under
`batch_rows` (a process's rows of a batch split over processes, set by the
train step) a draw with a batch dim is made at the whole batch's shape and
the process's rows are taken, so they equal the one-process draw's rows.

Over a model axis (the Trainer's mesh, parallel/mesh.py place_params) the
ruled weights come as `Shards` and `mha` and `ffn` run Megatron-style, one
shard after the other: Q/K/V column-parallel, each shard attending over
its n_head / n heads; `fc` and FFN w_2 row-parallel, their partials summed
in shard order where the call runs and w_2's bias added once; w_1 and its
bias column-parallel. The attention-probability dropout mask is drawn for
all heads, as the unsharded call draws it, and cut per shard, so both
compute the same function. place_params splits the attention projections
only where the heads divide over the shards, so a shard holds whole heads.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from stjep_tpu_torch.ops.attention import linear, linear_init
from stjep_tpu_torch.parallel.mesh import Shards

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


_ROWS: Optional[Tuple[int, int]] = None  # (start, total) while batch_rows is active


@contextlib.contextmanager
def batch_rows(start: int, total: int):
    """While active, the batches being drawn for are rows start.. of a
    batch of `total` rows (this process's cut, train/trainer.py): `uniform`
    draws at the whole batch's shape and takes these rows."""
    global _ROWS
    before, _ROWS = _ROWS, (start, total)
    try:
        yield
    finally:
        _ROWS = before


def uniform(generator: torch.Generator, shape, device, batch_dim: int = 0) -> torch.Tensor:
    """The uniform draw behind a dropout mask of `shape` on `device`; the
    batch lies on `batch_dim` (module docstring)."""
    gen = on_device(generator, device)
    if _ROWS is None:
        return torch.rand(shape, generator=gen, device=device)
    start, total = _ROWS
    whole = list(shape)
    whole[batch_dim] = total
    if start + shape[batch_dim] > total:
        raise ValueError(f"a draw of {shape[batch_dim]} rows at row {start} of {total}")
    return torch.rand(whole, generator=gen, device=device).narrow(batch_dim, start,
                                                                  shape[batch_dim])


def _keep_where(u: torch.Tensor, x: torch.Tensor, rate: float) -> torch.Tensor:
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            training: bool) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate and scale by
    1 / (1 - rate), as `jnp.where(mask, x / keep, 0)`."""
    if not training or rate <= 0.0:
        return x
    return _keep_where(uniform(generator, x.shape, x.device), x, rate)


def layer_norm_init(dim: int, device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((dim,), device=device, dtype=dtype),
            "bias": torch.zeros((dim,), device=device, dtype=dtype)}


def layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def mha_init(generator: torch.Generator, n_head: int, d_model: int, d_k: int,
             d_v: int, device=None, dtype=torch.float32) -> Dict:
    return {
        "w_qs": linear_init(generator, d_model, n_head * d_k, bias=False, device=device, dtype=dtype),
        "w_ks": linear_init(generator, d_model, n_head * d_k, bias=False, device=device, dtype=dtype),
        "w_vs": linear_init(generator, d_model, n_head * d_v, bias=False, device=device, dtype=dtype),
        "fc": linear_init(generator, n_head * d_v, d_model, bias=False, device=device, dtype=dtype),
        "layer_norm": layer_norm_init(d_model, device, dtype),
    }


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         temperature: float,
                         mask: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         training: bool = False,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, L, n, d]; mask broadcastable to [B, 1, Lq, Lk] with
    0 = blocked. Returns [B, Lq, n, d]. u: the dropout draw [B, n, Lq, Lk]
    when it was taken elsewhere (a model shard's heads)."""
    attn = torch.einsum("bqnd,bknd->bnqk", q / temperature, k)
    if mask is not None:
        attn = attn.masked_fill(mask == 0, ATTN_MASK_FILL)
    attn = torch.softmax(attn, dim=-1)
    if u is not None:
        attn = _keep_where(u, attn, ATTN_DROPOUT)
    else:
        attn = dropout(generator, attn, ATTN_DROPOUT, training)
    return torch.einsum("bnqk,bknd->bqnd", attn, v)


_MHA_W = ("w_qs", "w_ks", "w_vs", "fc")


def _mha_split(params: Dict, q, k, v, n_head: int, mask, generator, dropout_rate: float,
               training: bool) -> torch.Tensor:
    """mha over a model axis (module docstring); its arguments' meaning."""
    wq, wk, wv, wo = (params[nm]["w"] for nm in _MHA_W)
    n, lead = len(wq), q.device
    if n_head % n:
        raise ValueError(f"{n_head} heads do not divide over {n} model shards")
    h = n_head // n
    d_k = wq[0].shape[1] // h
    B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
    qn = layer_norm(params["layer_norm"], q, eps=1e-6)
    r1, r2 = split(generator)
    u = (uniform(r1, (B, n_head, Lq, Lk), lead)
         if training and ATTN_DROPOUT > 0.0 else None)
    out = None
    for s in range(n):
        dev = wq[s].device

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], h, -1)

        o = scaled_dot_attention(
            heads(qn.to(dev) @ wq[s]), heads(k.to(dev) @ wk[s]), heads(v.to(dev) @ wv[s]),
            d_k ** 0.5, mask=mask[:, None].to(dev) if mask is not None else None,
            u=None if u is None else u[:, s * h:(s + 1) * h].to(dev))
        part = (o.reshape(B, Lq, -1) @ wo[s]).to(lead)
        out = part if out is None else out + part
    return dropout(r2, out, dropout_rate, training) + q


def mha(params: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        n_head: int, mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, dropout_rate: float = 0.0,
        training: bool = False) -> torch.Tensor:
    """Multi-head attention with the residual; mask [B, Lq|1, Lk]. Split
    weights (Shards) run over the model axis (module docstring)."""
    if isinstance(params["w_qs"]["w"], Shards):  # Q, K, V and fc are split alike
        return _mha_split(params, q, k, v, n_head, mask, generator, dropout_rate, training)
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


def ffn_init(generator: torch.Generator, d_in: int, d_hid: int, device=None,
             dtype=torch.float32) -> Dict:
    return {"w_1": linear_init(generator, d_in, d_hid, device=device, dtype=dtype),
            "w_2": linear_init(generator, d_hid, d_in, device=device, dtype=dtype),
            "layer_norm": layer_norm_init(d_in, device, dtype)}


def ffn(params: Dict, x: torch.Tensor, generator: Optional[torch.Generator] = None,
        dropout_rate: float = 0.0, training: bool = False) -> torch.Tensor:
    """LN -> w_1 -> relu -> w_2 -> dropout -> + x; split weights (Shards)
    run over the model axis (module docstring)."""
    y = layer_norm(params["layer_norm"], x, eps=1e-6)
    if isinstance(params["w_1"]["w"], Shards):  # w_1, its bias and w_2 are split alike
        out = None
        for a, b, c in zip(params["w_1"]["w"], params["w_1"]["b"], params["w_2"]["w"]):
            part = (torch.relu(y.to(a.device) @ a + b) @ c).to(x.device)
            out = part if out is None else out + part
        y = out + params["w_2"]["b"]
    else:
        y = linear(params["w_2"], torch.relu(linear(params["w_1"], y)))
    return dropout(generator, y, dropout_rate, training) + x


def encoder_layer_init(generator: torch.Generator, d_model: int, n_head: int,
                       d_ff: int, device=None, dtype=torch.float32) -> Dict:
    d_k = d_model // n_head
    return {"slf_attn": mha_init(generator, n_head, d_model, d_k, d_k, device, dtype),
            "pos_ffn": ffn_init(generator, d_model, d_ff, device, dtype)}


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
                       d_ff: int, device=None, dtype=torch.float32) -> Dict:
    d_k = d_model // n_head
    return {"decslf_attn": mha_init(generator, n_head, d_model, d_k, d_k, device, dtype),
            "encdec_attn": mha_init(generator, n_head, d_model, d_k, d_k, device, dtype),
            "pos_ffn": ffn_init(generator, d_model, d_ff, device, dtype)}


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
