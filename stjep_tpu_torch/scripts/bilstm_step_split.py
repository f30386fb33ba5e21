#!/usr/bin/env python3
"""Where a step of K1's cluster sweep goes, on one GPU.

    python3 stjep_tpu_torch/scripts/bilstm_step_split.py [--pairs 4x8 8x16]

Builds a copy of csrc/bilstm.cu with timer reads (%globaltimer, ns) at the
phase boundaries of the step loop, taken by thread 0 of the first block of
the first cluster, and runs that copy once per (BT, C) pair on one layer of
the flagship pyramid (B = 16, T = 1504, H = 256, all rows full length).
Prints per phase its nanoseconds a step, averaged over the T steps, and
the whole sweep's time from CUDA events. The timer reads cost time of
their own, so the phases add up to more than the uninstrumented kernel
takes (scripts/bilstm_tune.py times that one). The copy is built under
stjep_tpu_torch/build/ (git ignores it).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "stjep_tpu_torch" / "csrc" / "bilstm.cu"
BUILD = ROOT / "stjep_tpu_torch" / "build" / "step_split"
PHASES = ["product", "xp copy wait", "cell", "block sync + slice copy", "arrive",
          "next copy + stores", "wait"]
# (line of the step loop, timer points put before and after it)
ANCHORS = [
    ("    cp_async_wait<0>();  // this step's xp copied\n", 0, 1),
    ("    __syncthreads();  // the block's slice", 2, None),
    ("    cluster_arrive();  // this block's h slice is in every peer\n", 3, 4),
    ("    cluster_wait();  // every peer's slice is here, and every peer has read h_{t-1}\n",
     5, 6),
]
PRELUDE = """
__device__ unsigned long long split_acc[8];
__device__ __forceinline__ unsigned long long split_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define SPLIT(n) if (split_on) { const unsigned long long t_ = split_now(); split_acc[n] += t_ - split_last; split_last = t_; }
"""
EPILOGUE = """
extern "C" int split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, split_acc, sizeof(split_acc));
}
extern "C" int split_zero() {
  unsigned long long z[8] = {0};
  return (int)cudaMemcpyToSymbol(split_acc, z, sizeof(z));
}
"""


def instrumented() -> str:
    s = SRC.read_text()
    start = "  cluster.sync();  // every peer runs, with its h buffer 0 zeroed\n"
    s = s.replace('#include "common.cuh"', f'#include "{SRC.parent / "common.cuh"}"\n{PRELUDE}')
    s = s.replace(start, start + "  const bool split_on = tid == 0 && blockIdx.x == 0 && blockIdx.y == 0;\n"
                  "  unsigned long long split_last = split_on ? split_now() : 0;\n")
    for line, before, after in ANCHORS:
        if s.count(line) != 1:
            raise RuntimeError(f"anchor not found once in {SRC.name}: {line!r}")
        s = s.replace(line, f"    SPLIT({before})\n" + line
                      + (f"    SPLIT({after})\n" if after is not None else ""))
    return s + EPILOGUE


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", nargs="+", default=["4x8", "4x16", "8x16", "16x8"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[failed] phase=device error=no CUDA device", flush=True)
        return 2
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib_path = BUILD / "bilstm_split.cu", BUILD / "libbilstm_split.so"
    src.write_text(instrumented())
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.bilstm_recurrent
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    B, T, H = 16, 1504, 256
    rng = np.random.RandomState(0)
    t = lambda *s, a=1.0: torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).cuda()
    xp, w = [t(B * T, 4 * H), t(B * T, 4 * H)], [t(H, 4 * H, a=H ** -0.5), t(H, 4 * H, a=H ** -0.5)]
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    out = torch.empty(B, T, 2 * H, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for pair in args.pairs:
        bt, c = map(int, pair.split("x"))
        lib.split_zero()
        ptrs = [x.data_ptr() for x in (*xp, *w, lens, out)]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        rc = fn(*ptrs, B, T, H, bt, c, torch.cuda.current_stream().cuda_stream)
        b.record()
        torch.cuda.synchronize()
        acc = (ctypes.c_ulonglong * 8)()
        lib.split_read(acc)
        if rc != 0:
            print(f"[failed] phase=launch error=BT={bt} C={c} returned {rc}", flush=True)
            return 1
        split = {name: round(acc[i] / T, 1) for i, name in enumerate(PHASES)}
        print(f"BT={bt} C={c} sweep_ms={a.elapsed_time(b):.3f} ns_per_step={split} "
              f"sum_ns={round(sum(split.values()), 1)}", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
