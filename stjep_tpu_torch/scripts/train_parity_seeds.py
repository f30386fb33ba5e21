#!/usr/bin/env python3
"""Read chip_smoke.py's train-parity gate over several seeds on one GPU.

    python3 stjep_tpu_torch/scripts/train_parity_seeds.py [--seeds 0 1 2 ...]

For each seed: one deterministic ASR_ST step at full widths (B=2, 256
frames; chip_smoke.train_parity_readings): the kernel route on the card and
the plain route on CPU copies, both f32, each against the plain route in
float64 on the same ReLU pieces. Prints one line per seed (loss and worst
gradient leaf of each f32 arm, the ReLU entries whose sign differs between
arms, and the card-vs-CPU reading without shared pieces), then the five
leaves furthest from float64 on the card and the five furthest apart
between card and CPU. Exits non-zero if a seed fails chip_smoke's limits;
the other seeds are still read.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_parity_seeds: needs a CUDA device", file=sys.stderr)
        return 2
    from stjep_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    failed = []
    for seed in args.seeds:
        r = cs.train_parity_readings(seed)
        ok = (r["worst_grad_card"] <= cs.PARITY_TOL and r["loss_rel_card"] <= 1e-4
              and max(r["adam_step_err_lr_card"], r["adam_step_err_lr_cpu"]) <= 1e-2)
        cs.say("train parity seed", ok=ok, tol_grad=cs.PARITY_TOL,
               **{k: v for k, v in r.items() if k != "leaves"})
        for col, what in ((1, "card vs float64"), (3, "card vs cpu, no shared pieces")):
            print(f"  worst leaves, {what}:")
            for name, e_card, e_cpu, e_pair in sorted(r["leaves"], key=lambda x: -x[col])[:5]:
                print(f"    {name:56s} card {e_card:.3e}  cpu {e_cpu:.3e}  "
                      f"card-cpu {e_pair:.3e}", flush=True)
        if not ok:
            failed.append(seed)
    print(f"seeds failing the gate: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
