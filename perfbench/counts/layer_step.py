"""The work of one decoder layer's beam step (K5): for each traced call of
stjep_tpu_torch.models.tf_decoder.decoder_layer_step_flash,
yardstick.decode_bound for one layer at its position, the distinct cache
rows its ancestry reads and the valid memory rows."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench import yardstick as y
from perfbench.tracing import arg


def keep(args: Dict, out) -> Tuple:
    return (int(arg(args, "pos")), arg(args, "x_new", 2).shape[0],
            arg(args, "anc", 2, torch.int32), int(arg(args, "group")),
            arg(args, "mem_mask", 2), arg(args, "cache_k", 4).element_size())


def count(kept: List[Tuple], model: Dict) -> Tuple[int, int]:
    n_bytes = flops = 0
    for pos, BK, anc, K, mem_mask, itemsize in kept:
        rows = y.distinct_rows(anc.cpu().numpy(), K, pos)
        b, f = y.decode_bound(model["dim_model"], model["dim_feedforward"], 1, BK, K, pos, rows,
                              int(mem_mask.sum()), mem_mask.numel(), itemsize)
        n_bytes, flops = n_bytes + b, flops + f
    return n_bytes, flops
