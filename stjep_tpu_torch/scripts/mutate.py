#!/usr/bin/env python3
"""Mutation check of the decode kernels (csrc/decode.cu, csrc/gemm.cu) on one GPU,
the tensor-parallel head (K7c) included.

    python3 stjep_tpu_torch/scripts/mutate.py [--workdir DIR]

Copies the package and tests/test_torch_cuda.py into DIR (by default
stjep_tpu_torch/build/mutants, which git ignores), first unchanged and then
once per mutation below, each a one-line change of a kernel source; builds each
copy's kernels and runs the decode cases of the card tests against it. The
unchanged copy must pass and every mutant should fail. Prints one line per
run; exits non-zero if the unchanged copy fails or a mutant passes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SELECT = ("layer_step or head or gather or beam_step or beam_select or "
          "general_beam or forward_eval or gemm_q8 or attn_kernels or serving or tp_")

# (what it breaks, the source in csrc/, the line as it is, the line as the
# mutant has it)
MUTATIONS = [
    ("tie order in head_topk's row scan", "decode.cu",
     "      if (!better(v, c, bv, bi)) continue;",
     "      if (!(v >= bv)) continue;"),
    ("glp without the log-sum-exp", "decode.cu",
     "    if (glp) glp[r] = glog - lse;",
     "    if (glp) glp[r] = glog;"),
    ("last taken id forgotten", "decode.cu",
     "      for (int j = 0; j < k; ++j) was_taken |= taken[j] == c;",
     "      for (int j = 0; j + 1 < k; ++j) was_taken |= taken[j] == c;"),
    ("online sum not rescaled", "decode.cu",
     "      z = z * expf(m - v) + 1.f;",
     "      z = z + 1.f;"),
    ("self attention reads the own slot at every position", "decode.cu",
     "    slot[l] = l == pos ? own : anc[(size_t)l * BK + r];",
     "    slot[l] = own;"),
    ("select keeps the score without the old penalty", "decode.cu",
     "      scores_o[s] = bv * lp_old;",
     "      scores_o[s] = bv;"),
    ("int8 scale applied along the wrong axis (row k, not column n)", "gemm.cu",
     "    return (float)__ldg(q + idx) * __ldg(s + n);",
     "    return (float)__ldg(q + idx) * __ldg(s + min(k, n));"),
    ("new bf16 K/V row truncated, not rounded to nearest", "decode.cu",
     "__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }",
     "__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rz(v); }"),
    ("bf16 q.k products summed unrounded", "decode.cu",
     "  return acc + __bfloat162float(__float2bfloat16_rn(q * __bfloat162float(k)));",
     "  return fmaf(q, __bfloat162float(k), acc);"),
    ("bf16 scaled query not rounded to bf16", "decode.cu",
     "  return __bfloat162float(__float2bfloat16_rn(x));",
     "  return x;"),
    ("a vocabulary shard's raw scores minus its own log-sum-exp", "decode.cu",
     "  const float lse = partial ? 0.f : mx + logf(se);  // partial: raw logits out",
     "  const float lse = mx + logf(se);"),
    ("sum-exp not rescaled to the block max", "decode.cu",
     "  const float se = block_sum(m == -INFINITY ? 0.f : z * expf(m - mx), red);",
     "  const float se = block_sum(m == -INFINITY ? 0.f : z, red);"),
    ("a shard narrower than K: 0, not -1e30, past its width", "decode.cu",
     "        sc[(size_t)r * K + k] = -1e30f;",
     "        sc[(size_t)r * K + k] = 0.f;"),
]


def run(workdir: Path, label: str, mutation=None) -> int:
    """Copy, mutate, build and test; returns pytest's exit code."""
    dst = workdir / label.replace(" ", "_")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "stjep_tpu_torch", dst / "stjep_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (dst / "tests").mkdir(parents=True)
    shutil.copy(ROOT / "tests" / "test_torch_cuda.py", dst / "tests")
    if mutation is not None:
        _, name, old, new = mutation
        src = dst / "stjep_tpu_torch" / "csrc" / name
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutation site not found once: {old!r}")
        src.write_text(text.replace(old, new))
    env = {**os.environ, "PYTHONPATH": str(dst)}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda",
         "--noconftest", "-q", "-p", "no:cacheprovider", "-k", SELECT],
        cwd=dst, env=env, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    print(f"[{label}] rc={proc.returncode} {lines[-1] if lines else proc.stderr[-500:]}",
          flush=True)
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", type=Path,
                    default=ROOT / "stjep_tpu_torch" / "build" / "mutants")
    args = ap.parse_args()
    args.workdir.mkdir(parents=True, exist_ok=True)
    if run(args.workdir, "unchanged") != 0:
        print("the unchanged copy fails its tests", flush=True)
        return 1
    survived = [m[0] for i, m in enumerate(MUTATIONS)
                if run(args.workdir, f"mutation {i}", m) == 0]
    print(f"mutants caught: {len(MUTATIONS) - len(survived)} of {len(MUTATIONS)}; "
          f"not caught: {survived}", flush=True)
    shutil.rmtree(args.workdir, ignore_errors=True)
    return 1 if survived else 0


if __name__ == "__main__":
    sys.exit(main())
