"""The work of the fused beam step (K4): for each traced call of
stjep_tpu_torch.infer.beam.decode_beam_step_flash, yardstick.megastep_bound
at its position i, the distinct cache rows its ancestry reads and the
valid memory rows."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench import yardstick as y
from perfbench.tracing import arg


def keep(args: Dict, out) -> Tuple:
    """What a call leaves for the count: references, read after the call
    (anc[i - 1] is written in place during it)."""
    preds = arg(args, "preds", 2, torch.int32)
    return (int(arg(args, "i")), tuple(preds.shape), arg(args, "anc", 2, torch.int32),
            arg(args, "mem_mask", 2), arg(args, "cache_k", 5).element_size(),
            int(arg(args, "group")))


def count(kept: List[Tuple], model: Dict) -> Tuple[int, int]:
    n_bytes = flops = 0
    for i, (BK, Lbuf), anc, mem_mask, itemsize, K in kept:
        rows = y.distinct_rows(anc.cpu().numpy(), K, i - 1)
        b, f = y.megastep_bound(model["dim_model"], model["dim_feedforward"], model["dec_layers"],
                                BK, K, i, rows, int(mem_mask.sum()), mem_mask.numel(),
                                model["dec_vocab_size"], Lbuf, itemsize)
        n_bytes, flops = n_bytes + b, flops + f
    return n_bytes, flops
