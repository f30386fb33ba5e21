"""Tensor-parallel decode over a model axis driven from one process (port of
stjep_tpu/ops/decode_flash_tp.py).

Under a mesh with n_model > 1 the decoder weights are split Megatron-style
(parallel/mesh.py). A layer step is then the trio of K6a-c on every shard,
each returning a partial with no residual (`residual=False`,
`partial_tp=True`), and one sum over the shards joins the partials before
each residual add: three launches and three joins per layer and shard. The
head is vocabulary-split: K7c (`decode_head_partial`) gives each shard's
raw top-K logits and (max, sumexp); the global log-softmax normaliser is
lse = max, then sum over the shards, and the candidates are concatenated
shard-major, so that local id + s * V/n is the global id, and re-ranked
with the lowest index first among ties, as the dense head ranks them.

JAX runs these functions inside `jax.shard_map`, one program per shard.
Here one process holds all n shards: a `ModelAxis` stands for the axis
name, a per-shard value is a list with one entry per shard, and each join
takes the shards' tensors, copies them to each shard's device (nothing
moves when the shards share a card) and sums them in shard order. Every
shard thus holds bit-identical joined values, as after JAX's psum, and the
beam bookkeeping that follows runs once, in lockstep with every shard.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from stjep_tpu_torch.ops.decode_flash import (
    cross_attn_step,
    decode_head_partial,
    ffn_step,
    self_attn_step,
    topk_lowest_index,
)


class ModelAxis:
    """The model axis of one data shard: the shards' devices, in shard
    order. A per-shard value is a list of `size` tensors, entry s on
    devices[s]. Joined values are computed once per distinct device and
    shared by the shards on it."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_index(self) -> List[int]:
        return list(range(self.size))

    def fan(self, fn: Callable[[int], torch.Tensor]) -> List[torch.Tensor]:
        """[fn(s) for each shard s], calling fn only for the first shard on
        each device: for a value every shard holds alike (a join, or what
        is computed from joined and replicated values alone)."""
        first: Dict[torch.device, torch.Tensor] = {}
        out = []
        for s, dev in enumerate(self.devices):
            if dev not in first:
                first[dev] = fn(s)
            out.append(first[dev])
        return out

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        return self.fan(lambda s: t.to(self.devices[s]))

    def _join(self, parts, op):
        def joined(s):
            acc = parts[0].to(self.devices[s])
            for p in parts[1:]:
                acc = op(acc, p.to(self.devices[s]))
            return acc
        return self.fan(joined)

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._join(parts, torch.add)

    def pmax(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._join(parts, torch.maximum)

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
        """The shards' tensors concatenated along dim in shard order (JAX
        all_gather(tiled=True))."""
        return self.fan(lambda s: torch.cat([p.to(self.devices[s]) for p in parts], dim))


def decoder_layer_step_flash_tp(params: Sequence[Dict], x_new, cache_k,
                                cache_v, mem_k, mem_v, pos: int,
                                n_head_local: int, anc, group: int, mem_mask,
                                self_mask_k, axis: ModelAxis) -> List[torch.Tensor]:
    """One decoder layer's decode step, tensor-parallel over `axis`. Every
    argument but pos, n_head_local and group is per-shard: params the
    shards' layer trees, x_new the layer input [BK, D] (alike on every
    shard), caches [K, B, Lpad, D/n] and memory K/V [B, Lk_pad, D/n] (each
    shard's own; the caches update in place), anc, masks. Returns the
    layer output [BK, D] per shard, alike on every shard. It launches
    nothing itself: K6a-c count their own launches."""
    n = axis.size
    y1p = [self_attn_step(params[s]["decslf_attn"], x_new[s], cache_k[s],
                          cache_v[s], pos, n_head_local, anc[s], group,
                          self_mask_k[s], residual=False) for s in range(n)]
    j = axis.psum(y1p)
    y1 = axis.fan(lambda s: x_new[s] + j[s])
    y2p = [cross_attn_step(params[s]["encdec_attn"], y1[s], mem_k[s], mem_v[s],
                           n_head_local, group, mem_mask[s], residual=False)
           for s in range(n)]
    j = axis.psum(y2p)
    y2 = axis.fan(lambda s: y1[s] + j[s])
    y3p = [ffn_step(params[s]["pos_ffn"], y2[s], partial_tp=True) for s in range(n)]
    j = axis.psum(y3p)
    b2 = [p["pos_ffn"]["w_2"]["b"] for p in params]
    return axis.fan(lambda s: y2[s] + j[s] + b2[s])


def decode_head_tp(norm_params: Sequence[Dict], out_params: Sequence[Dict], x,
                   topk: int, axis: ModelAxis,
                   gather_ids: Optional[torch.Tensor] = None):
    """The vocabulary-split decode head; decode_head's (decode_head_gather's)
    contract per shard. norm_params, out_params (vocab shards [D, V/n]) and
    x [BK, D] are per-shard; gather_ids [BK] holds GLOBAL ids. Returns
    per-shard lists, alike on every shard: scores [BK, topk] (global
    log-softmax), ids [BK, topk] global int32 [, glp [BK]]."""
    n = axis.size
    v_local = out_params[0]["w"].shape[1]
    off = [s * v_local for s in axis.axis_index()]
    gids = None if gather_ids is None else axis.replicate(gather_ids.to(torch.int32))
    parts = [decode_head_partial(norm_params[s], out_params[s], x[s], topk,
                                 None if gids is None else gids[s] - off[s])
             for s in range(n)]
    mx = [p[2] for p in parts]
    mxg = axis.pmax(mx)
    seg = axis.psum([p[3] * torch.exp(mx[s] - mxg[s]) for s, p in enumerate(parts)])
    lse = axis.fan(lambda s: mxg[s] + torch.log(seg[s]))
    sc_all = axis.all_gather([p[0] for p in parts], 1)
    ids_all = axis.all_gather([p[1] + off[s] for s, p in enumerate(parts)], 1)

    def pick(s):
        val, sel = topk_lowest_index(sc_all[s], topk)
        return val - lse[s][:, None], ids_all[s].gather(1, sel).to(torch.int32)

    picked = axis.fan(pick)
    out = ([p[0] for p in picked], [p[1] for p in picked])
    if gather_ids is None:
        return out
    glog = axis.psum([p[4] for p in parts])
    return out + (axis.fan(lambda s: glog[s] - lse[s]),)
