"""The readings the limits are set from (not run by the benchmark's runs).

    python3 perfbench/control.py --workload <cell> --seeds 101,102,... \
        [--control-seeds 101,102,103] [--out FILE]

In one process, at the cell's own sizes on the card: for every seed, the
program's numbers (the lower readings: its timed path over the comparison's
sample, `check_batches` batches after one call a pool batch, or
`check_steps` steps, held to the float32 reference as a run holds them);
for each control seed, the control (the reference in TF32, the nearest
precision below float32 with TF32 off, in the program's place on the same
inputs, hypotheses and kept parents, read by the float32 reference) and,
for a training cell, the reference with each fault planted: half of the
batch left out (the mean taken over the rest), one target token altered
where the batch is fed; a state left unchanged reads 1 on change_err and
needs no run.
Prints one JSON line a reading and writes them to --out.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cut(batch, rows):
    return {k: v[:rows] for k, v in batch.items()}


def _altered(batch):
    t = batch["tgtid"].clone()
    t[0, 3] = 5 + (t[0, 3] - 4) % 195
    return {**batch, "tgtid": t}


def readings(run, entry, seed, control: bool):
    """The program's numbers for `seed` and, with control, the control's
    (and a training cell's faults)."""
    import torch

    from perfbench import checks
    from perfbench.weights import draw_params, leaf_paths

    run.seed = seed
    st = entry.setup(run)
    out = []
    if entry.UNIT == "batch":
        for _ in range(max(run.traffic["check_batches"], run.traffic["pool"])):
            entry.call(run, st)
        if control:
            prog, ctrl = entry.check(run, st, control=True)
            return out + [("program", prog), ("control tf32", ctrl)]
        return out + [("program", entry.check(run, st))]
    tr = run.traffic
    st.pop("opt")
    st.pop("step")  # the program's state is freed before the reference runs
    batches = [{k: torch.from_numpy(v).to(run.device) for k, v in st["pool"][i].items()}
               for i in range(tr["check_steps"])]

    def ref_steps(bs, tf32=False, rows=None):
        p0 = draw_params(run.model, seed, run.device)
        start = [t.detach().clone() for _, t in leaf_paths(p0)]
        got = checks.reference_steps(run.model, tr["mode"], p0, bs, tr["lr"],
                                     tr["max_grad_norm"], tf32=tf32,
                                     drops=entry.step_drops(st, rows))
        return got, start

    want, start = ref_steps(batches)
    prog = {**st["prog"], "change": [c.to(run.device) - s
                                     for c, s in zip(st["prog"]["change"], start)]}
    out.append(("program", checks.train_numbers(prog, want)))
    if control:
        half = tr["batch"] // 2
        variants = (("control tf32", batches, True, None),
                    ("fault half batch", [_cut(b, half) for b in batches], False, half),
                    ("fault altered token", [_altered(b) for b in batches], False, None))
        for label, bs, tf32, rows in variants:
            got, _ = ref_steps(bs, tf32, rows)
            out.append((label, checks.train_numbers(got, want)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    from perfbench import registry
    from perfbench.run import Run

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    bench = registry.benchmark()
    cell = registry.cell(bench, a.workload)
    run = Run(bench, cell, 0, 0, 0, torch.device("cuda", 0))
    entry = importlib.import_module(f"perfbench.entries.{run.traffic['entry']}")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control = {int(s) for s in a.control_seeds.split(",") if s}
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        for label, nums in readings(run, entry, seed, seed in control):
            line = {"cell": a.workload, "seed": seed, "reading": label,
                    **{k: v for k, v in nums.items() if not k.startswith("_")},
                    "seconds": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
