#!/usr/bin/env python3
"""How far the bf16-cache beam routes drift apart, on one GPU and its host.

    python3 stjep_tpu_torch/scripts/bf16_drift.py [--seed 0] [--n_model 2]

At chip_smoke.py's flagship (B=16, beam 5, bf16 caches, f32 weights), one
request is decoded by five routes: the single-device route and the
tensor-parallel (TP) route on a (1, n) mesh, each on the card (the CUDA
kernels) and on CPU copies of the weights (the plain versions), and the TP
route on the card with its attention kernels swapped for their plain
versions on the card. For each pair of routes it prints the rows whose
tokens part, the position where each parts and the kept-score gap there
(chip_smoke.py's first-divergence margin), and the drift before any row
parts: the largest difference of the sorted kept beam scores of a group at
positions 1, 2, 3, 5, 10, 20, 40 and 80, over the groups whose hypotheses
still agree there.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402

AT = (1, 2, 3, 5, 10, 20, 40, 80)


def drift(a, b):
    """{position: largest sorted kept-score gap over the groups whose
    hypotheses agree there} for the positions in AT."""
    out = {}
    for t, ((pa, sa), (pb, sb)) in enumerate(zip(a[2], b[2])):
        if t + 1 not in AT:
            continue
        gaps = [float((sa[g].sort()[0] - sb[g].sort()[0]).abs().max())
                for g in (slice(r * cs.BEAM, (r + 1) * cs.BEAM) for r in range(cs.B))
                if torch.equal(pa[g], pb[g])]
        out[t + 1] = max(gaps) if gaps else None
    return out


def compare(name, a, b):
    rows = {r: cs.beam_divergence(a[2], b[2], r)
            for r, c in enumerate(cs.first_diff(a[0], b[0])) if c is not None}
    cs.say(f"pair {name}", rows_part=len(rows), of=cs.B,
           rows={r: {"position": p, "margin": round(m, 6)} for r, (p, m) in rows.items()},
           drift_before_parting={k: (round(v, 6) if v is not None else None)
                                 for k, v in drift(a, b).items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_model", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_drift: needs a CUDA device", file=sys.stderr)
        return 2
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.ops import decode_flash as df

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    cfg = ModelConfig(**cs.FLAGSHIP)
    params_c = init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu")
    params = params_to(params_c, "cuda")
    feats, lens = cs.inputs(np.random.RandomState(args.seed), cs.B)
    n, opts = args.n_model, cs.BF16_OPTS
    runs, secs = {}, {}

    def run(label, p, device, mesh, **kw):
        t0 = time.perf_counter()
        cs.tp_mesh(n if mesh else 0, device)
        try:
            runs[label] = cs.recorded_translate(p, cfg, feats, lens, device, **kw, **opts)
        finally:
            cs.tp_mesh(0)
        secs[label] = round(time.perf_counter() - t0, 1)

    run("single card", params, "cuda", False)
    run("single cpu", params_c, "cpu", False)
    run("tp card", params, "cuda", True, step="beam_select")
    run("tp cpu", params_c, "cpu", True, step="beam_select")
    kern = df._self_attn_cuda, df._cross_attn_cuda
    df._self_attn_cuda, df._cross_attn_cuda = df.self_attn_anc_plain, df.cross_attn_plain
    try:
        run("tp card plain attention", params, "cuda", True, step="beam_select")
    finally:
        df._self_attn_cuda, df._cross_attn_cuda = kern
    cs.say("routes", n_model=n, batch=cs.B, beam=cs.BEAM, seconds=secs)
    for a, b in (("tp card", "tp cpu"), ("single card", "single cpu"), ("tp cpu", "single cpu"),
                 ("tp card", "single card"), ("tp card", "tp card plain attention"),
                 ("tp card plain attention", "tp cpu")):
        compare(f"{a} | {b}", runs[a], runs[b])
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
