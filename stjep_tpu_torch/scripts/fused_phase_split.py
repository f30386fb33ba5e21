#!/usr/bin/env python3
"""Where a launch of the fused K5 and K4 goes, phase by phase, on one GPU.

    python3 stjep_tpu_torch/scripts/fused_phase_split.py [--seed 0] [--reps 20]

At chip_smoke.py's flagship shapes (B=16, beam 5, position 75 of 160 cache
rows, 96 memory rows): f32 on the full grid and on one block per SM (132),
and int8 weights with bf16 caches. The script builds the kernel library
with -DSTJEP_FUSED_STAMPS (a library of its own; the default build has no
timer reads), and each launch then records the global timer at its start
and after every grid barrier (csrc/decode_fused.cu `stamp`,
`decode_fused_stamps`). Prints,
per launch kind, the grid and the launch's time from CUDA events, and the
median microseconds of each phase kind summed over the launch (qkv, self,
fc, row, cq, cross, co, w1, w2; K4 also embed, head and select). The last
phase, which no barrier closes, is the event time less the stamped span,
so it carries the launch overhead.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def split(label, fn, plan, reps):
    """Run fn reps times with stamps on; print the phase kinds' medians."""
    from stjep_tpu_torch import kernels

    n = plan["barriers"]
    stamps = torch.zeros(2 + n, dtype=torch.int64, device="cuda")
    kernels.launch("decode_fused_stamps", stamps)
    fn()
    per_kind, totals = defaultdict(list), []
    try:
        for _ in range(reps):
            stamps.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total = a.elapsed_time(b) * 1e3
            st = stamps.cpu().numpy()
            assert st[0] == 1 + n, st[0]
            times = np.diff(st[1:2 + n]) / 1e3
            sums = defaultdict(float)
            for (kind, _), t in zip(plan["phases"], times):
                sums[kind] += t
            sums[plan["phases"][-1][0]] += total - (st[1 + n] - st[1]) / 1e3
            for k, v in sums.items():
                per_kind[k].append(v)
            totals.append(total)
    finally:
        kernels.launch("decode_fused_stamps", None)
    med = {k: round(statistics.median(v), 2) for k, v in per_kind.items()}
    cs.say(f"phases {label}", launch_us=round(statistics.median(totals), 2),
           barriers=n, us_by_phase=med)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_phase_split: needs a CUDA device", file=sys.stderr)
        return 2
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import _dec_embedder, init_seq2seq
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops.masks import position_signal

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.NVCC_FLAGS = [*kernels.NVCC_FLAGS, "-DSTJEP_FUSED_STAMPS"]
    kernels.lib()
    cfg = ModelConfig(**cs.FLAGSHIP)
    params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu"),
                       "cuda")
    rng = np.random.RandomState(args.seed)
    K, BK, i = cs.BEAM, cs.B * cs.BEAM, cs.DECODE_LEN // 2
    table = _dec_embedder(params, cfg).contiguous()
    tsig = position_signal(500, cfg.dim_model, "cuda")[0].contiguous()
    for quant, bf16, grid_blocks in ((False, False, 0), (False, False, 132), (True, True, 0)):
        df.FUSED_GRID = grid_blocks
        st = cs.decode_state(params, cfg, rng, i - 1, bf16=bf16)
        c = st["cache"]
        dec = cs.serving_decoder(params, quant)
        x = torch.from_numpy(rng.randn(BK, cfg.dim_model).astype(np.float32)).cuda()
        lp = dec["layers"][0]
        label = cs.variant_label(quant, bf16)
        Lpad, Lk = c.self_k.shape[3], c.mem_k.shape[2]
        plan5 = df.fused_plan(BK, cfg.dim_model, cfg.dim_feedforward, cfg.num_heads, Lpad, Lk,
                              quant, K=K)
        grid = grid_blocks or df.fused_grid(quant, bf16, False, plan5["smem"])["blocks"]
        label = f"{label} grid={grid}"
        split(f"K5 {label}", lambda: df.decoder_layer_step_flash(
            lp, x, c.self_k[0], c.self_v[0], c.mem_k[0], c.mem_v[0], i - 1, cfg.num_heads,
            st["anc"], K, st["mem_mask"], st["maskk"]), plan5, args.reps)
        plan4 = df.fused_plan(BK, cfg.dim_model, cfg.dim_feedforward, cfg.num_heads, Lpad, Lk,
                              quant, True, cfg.dec_layers, cfg.dec_vocab_size, K)
        eos = torch.zeros(BK, dtype=torch.int32, device="cuda")
        scores = torch.zeros(BK, device="cuda")
        lenm = torch.ones(BK, device="cuda")
        stacked = df.stack_decoder_layers(dec)
        last_tok = st["preds"][:, i - 1].contiguous()
        split(f"K4 {label}", lambda: df.decode_beam_step_flash(
            stacked, dec["norm"], params["out_tgt"], table, tsig, i, last_tok, st["preds"],
            st["anc"], st["maskk"], st["mem_mask"], scores, eos, lenm, c.self_k, c.self_v,
            c.mem_k, c.mem_v, cfg.num_heads, K, 1.0), plan4, args.reps)
    df.FUSED_GRID = 0
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
