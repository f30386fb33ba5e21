#!/usr/bin/env python3
"""Bounds of the tensor-parallel decode kernels for one model shard: K6a-c
(stjep_tpu/ops/decode_flash.py `self_attn_step` :348, `cross_attn_step`
:543, `ffn_step` :622), their trio (:869) and K7c `decode_head_partial`
(:1666).

    python3 stjep_tpu_torch/scripts/tp_bounds.py [--n_model 4]

Defaults are the flagship beam's shapes: B=16, beam 5 (80 rows), D=512,
FF 1024, 8 heads, decode position 75 of a 160-row f32 cache with every
slot live, 89 memory rows, V=200; each shard holds D / n_model of the
attention width, FF / n_model of the FFN and V / n_model of the head.
chip_smoke.py calls `tp_kernel_work` with its own run's counts (the
distinct cache rows its ancestry reads, its valid memory rows). A bound is
the larger of the bytes each kernel must move (every input once, every
output once) over 3.35 TB/s and its f32 operations over 67 TFLOP/s, the
H100 SXM peaks at 700 W. Runs anywhere: arithmetic from shapes, no device.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

HBM, PEAK_F32 = 3.35e12, 67e12


def bound_ms(n_bytes: float, flops: float):
    t_b, t_o = n_bytes / HBM, flops / PEAK_F32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def tp_kernel_work(n_model: int, B: int = 16, K: int = 5, D: int = 512, FF: int = 1024,
                   V: int = 200, pos: int = 75, Lk: int = 89, topk: int = 5,
                   self_rows: Optional[int] = None, mem_rows: Optional[int] = None,
                   cache_itemsize: int = 4) -> Dict[str, Tuple[int, int]]:
    """(bytes, f32 operations) per kernel for one shard of n_model at
    position `pos`: self_rows, the distinct cache rows below pos the
    ancestry reads (K * B * pos when every slot is live), and mem_rows,
    the valid memory rows (B * Lk), count what the call's data needs."""
    f, c = 4, cache_itemsize
    BK, Dq, n = B * K, D // n_model, n_model
    self_rows = K * B * pos if self_rows is None else self_rows
    mem_rows = B * Lk if mem_rows is None else mem_rows
    x_io = 2 * BK * D * f  # the layer input in, its partial output out
    work = {
        # 4 [D, Dq] matrices, the LayerNorm, x in / y out, the cache rows
        # read and the new rows written, q/k/v, the ancestry and mask columns
        "self_attn_step": (4 * D * Dq * f + 2 * D * f + x_io + 2 * self_rows * Dq * c
                           + 2 * BK * Dq * c + 2 * (pos + 1) * BK * 4,
                           2 * BK * 4 * D * Dq + 4 * BK * (pos + 1) * Dq),
        "cross_attn_step": (2 * D * Dq * f + 2 * D * f + x_io + 2 * mem_rows * Dq * c
                            + Lk * B * 4,
                            2 * BK * 2 * D * Dq + 4 * K * mem_rows * Dq),
        "ffn_step": (2 * D * (FF // n) * f + (FF // n + 3 * D) * f + x_io,
                     2 * BK * 2 * D * (FF // n)),
        "decode_head_partial": ((2 * D + D * V // n) * f + BK * D * f
                                + BK * (2 * topk + 2) * f,
                                2 * BK * D * V // n),
    }
    work["trio"] = tuple(sum(work[k][i] for k in ("self_attn_step", "cross_attn_step",
                                                  "ffn_step")) for i in range(2))
    return work


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_model", type=int, default=4)
    n = ap.parse_args().n_model
    for name, (n_bytes, flops) in tp_kernel_work(n).items():
        ms, by = bound_ms(n_bytes, flops)
        print(f"{name}: n_model={n} bytes={n_bytes} flops={flops} bound_ms={ms:.6f} "
              f"bound_by={by}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
