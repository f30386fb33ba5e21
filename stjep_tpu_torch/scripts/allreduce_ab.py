#!/usr/bin/env python3
"""Where the two-rank train step's all-reduce spends its time: one flat f32
bucket summed over two gloo ranks on one card, four ways, in one run.

    python3 stjep_tpu_torch/scripts/allreduce_ab.py [--numel 75455026] [--reps 7]
        [--device cuda|cpu]

It starts two ranks of itself (`--rank`) on a `file://` rendezvous in a
fresh temporary directory; each calls parallel/distributed.py's
`init_distributed` and sums a bucket of `--numel` values (by default the
flagship step's: 75 455 024 gradient values and two losses, 301 820 104
bytes) made from the rank's seed. The arms, in turns, 2 warm-up and
`--reps` timed calls each (host clock, a barrier and the card drained
before each call, drained after it):

- direct: `distributed.all_reduce_sum` on the card's bucket (gloo copies
  it to host memory and back itself);
- fresh pinned: a pinned host buffer allocated for the call, the bucket
  copied in, reduced there and copied back;
- kept pinned: the same through one pinned buffer kept across calls;
- host: the reduce of a host bucket alone (no copy): loopback gloo's own
  cost;
- copies: the two copies of kept pinned alone, no reduce.

With `--device cpu` only host runs. Rank 0 prints one JSON line: each
arm's times and median ms, and whether every arm's sum equals direct's
bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from stjep_tpu_torch.parallel import distributed  # noqa: E402

NUMEL = 75_455_026  # the flagship step's bucket: 75 455 024 gradient values and two losses


def rank_main(args) -> int:
    import torch.distributed as dist

    dev = torch.device(args.device)
    distributed.init_distributed(args.init, 2, args.rank, device=dev, local_world_size=2)
    gen = torch.Generator().manual_seed(args.rank)
    src = torch.randn(args.numel, generator=gen)
    bucket = src.to(dev)
    kept = torch.empty(args.numel, pin_memory=True) if dev.type == "cuda" else None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def direct():
        distributed.all_reduce_sum(bucket)

    def staged(buf):
        buf.copy_(bucket)
        dist.all_reduce(buf)
        bucket.copy_(buf)

    def copies():
        kept.copy_(bucket)
        bucket.copy_(kept)

    host = src.clone()
    arms = {"host": lambda: dist.all_reduce(host)}
    if dev.type == "cuda":
        arms = {"direct": direct,
                "fresh pinned": lambda: staged(torch.empty(args.numel, pin_memory=True)),
                "kept pinned": lambda: staged(kept), "copies": copies, **arms}
    times = {k: [] for k in arms}
    sums = {}
    for i in range(2 + args.reps):
        for k in (list(arms) if i % 2 == 0 else list(arms)[::-1]):
            bucket.copy_(src)
            host.copy_(src)
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            arms[k]()
            sync()
            times[k].append((time.perf_counter() - t0) * 1e3)
            if k != "copies":
                sums[k] = (host if k == "host" else bucket).cpu()
    ref = sums["direct" if dev.type == "cuda" else "host"]
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "backend": dist.get_backend(), "numel": args.numel, "bytes": args.numel * 4,
           "equal_to_direct": {k: bool(torch.equal(v, ref)) for k, v in sums.items()},
           **{f"{k} ms": v[2:] for k, v in times.items()},
           **{f"{k} median_ms": statistics.median(v[2:]) for k, v in times.items()}}
    if distributed.is_primary():
        print(json.dumps(out), flush=True)
    distributed.barrier("done")
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--numel", type=int, default=NUMEL)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help="run one rank (started by main)")
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    with tempfile.TemporaryDirectory(prefix="allreduce_ab_") as tmp:
        cmd = [sys.executable, os.path.abspath(__file__), "--numel", str(args.numel),
               "--reps", str(args.reps), "--device", args.device,
               "--init", f"file://{tmp}/rendezvous"]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(2)]
        try:
            rcs = [p.wait(timeout=args.timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
