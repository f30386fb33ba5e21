#!/usr/bin/env python3
"""Batch tile BT and cluster size C of the BiLSTM cluster sweeps on one GPU.

    python3 stjep_tpu_torch/scripts/bilstm_tune.py [--batches 1 16 64] [--out FILE]

For each batch B and each (BT, C) pair, times the recurrent sweeps alone
(no input GEMMs) over the flagship pyramid's four layers (H = 256, T =
1504, 752, 376, 188, lengths drawn as chip_smoke.py draws them): K1
(`bilstm_recurrent`), and at B = 16 also K8's forward (`bilstm_fwd_save`)
and backward (`bilstm_bwd_recurrent`). Each time is the median of 5 CUDA
event timings after a warm-up; each pair's outputs are held against the
default pair's (`lstm_pallas.sweep_shape`) within 1e-5, and each sweep is
run twice to check that the two runs are bit-for-bit equal. Prints one line per
pair with its plan (blocks, threads, shared memory, where W_hh's slice
lives, clusters the card holds at once) and the card's nvidia-smi line;
with --out, also the rows as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from stjep_tpu_torch import kernels  # noqa: E402
from stjep_tpu_torch.ops.lstm_pallas import sweep_plan, sweep_shape  # noqa: E402

FRAMES, H = 1504, 256
PAIRS = [(bt, c) for bt in (4, 8, 16) for c in (8, 16)]


def ms(fn, reps=5):
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def layers(B, rng):
    """Per pyramid layer: xp of both directions, W_hh of both, lengths, g_out."""
    lens = torch.from_numpy(rng.randint(FRAMES // 2, FRAMES, size=(B,))).int().cuda()
    lens[0] = FRAMES
    T, out = FRAMES, []
    k = 1.0 / np.sqrt(H)
    for _ in range(4):
        t = lambda *s, a=1.0: torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).cuda()
        out.append(dict(T=T, xp=[t(B * T, 4 * H), t(B * T, 4 * H)],
                        whh=[t(H, 4 * H, a=k), t(H, 4 * H, a=k)], lens=lens.clone(),
                        g=t(B, T, 2 * H)))
        T, lens = T // 2, lens // 2
    return out


def sweeps(B, L, shape, train):
    """Run the sweeps of every layer at `shape`; returns {name: (fn, outputs)}."""
    runs = {}
    bufs = [dict(out=torch.empty(B, l["T"], 2 * H, device="cuda"),
                 hs=torch.empty(2, l["T"], B, H, device="cuda"),
                 cs=torch.empty(2, l["T"], B, H, device="cuda"),
                 gates=torch.empty(2, l["T"], B, 4 * H, device="cuda"),
                 dxp=torch.empty(2, l["T"], B, 4 * H, device="cuda")) for l in L]

    def k1():
        for l, b in zip(L, bufs):
            kernels.launch("bilstm_recurrent", *l["xp"], *l["whh"], l["lens"], b["out"],
                           B, l["T"], H, *shape)
    runs["K1"] = (k1, lambda: [b["out"].clone() for b in bufs])
    if train:
        def fwd():
            for l, b in zip(L, bufs):
                kernels.launch("bilstm_fwd_save", *l["xp"], *l["whh"], l["lens"], b["out"],
                               b["hs"], b["cs"], b["gates"], B, l["T"], H, *shape)

        def bwd():
            for l, b in zip(L, bufs):
                kernels.launch("bilstm_bwd_recurrent", l["g"], b["cs"], b["gates"],
                               *l["whh"], l["lens"], b["dxp"], B, l["T"], H, *shape)
        runs["K8 fwd"] = (fwd, lambda: [t.clone() for b in bufs
                                        for t in (b["out"], b["hs"], b["cs"], b["gates"])])
        runs["K8 bwd"] = (bwd, lambda: [b["dxp"].clone() for b in bufs])
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 64])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[failed] phase=device error=no CUDA device", flush=True)
        return 2
    kernels.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rows, ok = [], True
    for B in args.batches:
        L = layers(B, np.random.RandomState(B))
        outs = {}
        for shape in PAIRS:
            for name, (fn, grab) in sweeps(B, L, shape, train=B == 16).items():
                plan = sweep_plan(B, H, backward=name == "K8 bwd", shape=shape)
                fn()
                torch.cuda.synchronize()
                outs[name, shape] = grab()
                fn()
                torch.cuda.synchronize()
                repeat = all(torch.equal(a, b) for a, b in zip(outs[name, shape], grab()))
                rows.append(dict(B=B, kernel=name, ms=ms(fn), repeatable=repeat, **plan))
        for row in rows:
            if row["B"] != B:
                continue
            name, shape = row["kernel"], (row["bt"], row["c"])
            default = sweep_shape(B, H, backward=name == "K8 bwd")
            row["default"] = shape == default
            row["err_vs_default"] = max(float((a - b).abs().max())
                                        for a, b in zip(outs[name, shape], outs[name, default]))
            ok &= row["repeatable"] and (name == "K8 bwd" or row["err_vs_default"] <= 1e-5)
            print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    print(smi, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(nvidia_smi=smi, rows=rows), indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
