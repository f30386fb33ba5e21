#!/usr/bin/env python3
"""Bounds of the TPU kernels not ported yet: the tensor-parallel decode trio
(stjep_tpu/ops/decode_flash.py `self_attn_step` :348, `cross_attn_step`
:543, `ffn_step` :622) and `decode_head_partial` (:1666), for one model
shard at the flagship.

    python3 stjep_tpu_torch/scripts/tp_bounds.py [--n_model 4]

Shapes: B=16, beam 5 (80 rows), D=512, FF 1024, 8 heads, decode position 75
of a 160-row f32 cache with every slot live, 89 memory rows, V=200; each
shard holds D / n_model of the attention width, FF / n_model of the FFN and
V / n_model of the head. A bound is the larger of the bytes each kernel
must move (every input once, every output once) over 3.35 TB/s and its f32
operations over 67 TFLOP/s, the H100 SXM peaks at 700 W that chip_smoke.py
uses. Runs anywhere: arithmetic from shapes, no device.
"""

from __future__ import annotations

import argparse

HBM, PEAK_F32 = 3.35e12, 67e12


def bound_ms(n_bytes: float, flops: float):
    t_b, t_o = n_bytes / HBM, flops / PEAK_F32
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_model", type=int, default=4)
    n = ap.parse_args().n_model
    B, K, D, FF, V, pos, Lk, f = 16, 5, 512, 1024, 200, 75, 89, 4
    BK, Dq = B * K, 512 // n
    x_io = 2 * BK * D * f  # the layer input in, its partial output out
    kernels = {
        "self_attn_step": (4 * D * Dq * f + 2 * D * f + x_io
                           + 2 * K * B * pos * Dq * f + 2 * BK * Dq * f
                           + 2 * (pos + 1) * BK * 4,
                           2 * BK * 4 * D * Dq + 4 * BK * (pos + 1) * Dq),
        "cross_attn_step": (2 * D * Dq * f + 2 * D * f + x_io + 2 * B * Lk * Dq * f
                            + Lk * B * 4,
                            2 * BK * 2 * D * Dq + 4 * BK * Lk * Dq),
        "ffn_step": (2 * D * (FF // n) * f + (FF // n + 3 * D) * f + x_io,
                     2 * BK * 2 * D * (FF // n)),
        "decode_head_partial": ((2 * D + D * V // n) * f + BK * D * f + BK * (2 * K + 2) * f,
                                2 * BK * D * V // n),
    }
    for name, (n_bytes, flops) in kernels.items():
        ms, by = bound_ms(n_bytes, flops)
        print(f"{name}: n_model={n} bytes={n_bytes} flops={flops} bound_ms={ms:.6f} "
              f"bound_by={by}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
