#!/usr/bin/env python3
"""Mutation check of the kernels on one GPU: the decode kernels (the fused
K4, K5 and K6a-c in csrc/decode_fused.cu, K3 and K7c in
csrc/decode_chain.cu, their shared phases in csrc/decode_fused.cuh, the
attention, head and select bodies in csrc/attend.cuh and
csrc/head_select.cuh), the BiLSTM cluster sweeps (csrc/bilstm.cu,
csrc/bilstm_bwd.cu) and the fused LAS decoder kernels K2 and K9
(csrc/las_fused.cu).

    python3 stjep_tpu_torch/scripts/mutate.py [--workdir DIR] [--only TEXT[,TEXT]]

Copies the package and tests/test_torch_cuda.py into DIR (by default
stjep_tpu_torch/build/mutants, which git ignores), first unchanged and then
once per mutation below, each a change of one or two lines of a kernel
source; builds each copy's kernels and runs the card tests that cover that
source against it (each run within a time limit: a mutant that hangs
counts as caught; a mutation may name its own card tests, as the shard
steps' do). The unchanged copy must pass and every mutant should fail.
With --only, just the mutations whose source file name or description
contains one of TEXT's comma-separated parts (`--only K6`: the shard
steps' five; `--only K3,K7c`: the fused chain's and shard head's six).
Prints one line per run; exits non-zero if the unchanged copy fails or a
mutant passes.
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
          "general_beam or forward_eval or fused or serving or tp_")
SELECT_BILSTM = "bilstm"
SELECT_LAS = "las"
SELECT_TP = "tp_step or tp_steps or tp_attention or tp_trio"
SELECT_CHAIN = "chain or head_partial"
TIMEOUT_S = 900

# (what it breaks, the source in csrc/, the line as it is, the line as the
# mutant has it; a tuple of lines for a change of several; optionally the
# card tests to run, a -k expression)
MUTATIONS = [
    ("tie order in head_topk's row scan", "head_select.cuh",
     "      if (!better(v, c, bv, bi)) continue;",
     "      if (!(v >= bv)) continue;"),
    ("glp without the log-sum-exp", "head_select.cuh",
     "    if (glp) glp[r] = glog - lse;",
     "    if (glp) glp[r] = glog;"),
    ("last taken id forgotten", "head_select.cuh",
     "      for (int j = 0; j < k; ++j) was_taken |= taken[j] == c;",
     "      for (int j = 0; j + 1 < k; ++j) was_taken |= taken[j] == c;"),
    ("online sum not rescaled", "head_select.cuh",
     "      z = z * expf(m - v) + 1.f;",
     "      z = z + 1.f;"),
    ("self attention reads the own slot at every position", "attend.cuh",
     "    slot[l] = l == pos ? own : anc[(size_t)l * BK + r];",
     "    slot[l] = own;"),
    ("select keeps the score without the old penalty", "head_select.cuh",
     "      scores_o[s] = bv * lp_old;",
     "      scores_o[s] = bv;"),
    ("int8 weights dequantized with a neighbouring column's scale", "decode_fused.cuh",
     "  return make_float4((float)q.x * s.x, (float)q.y * s.y, (float)q.z * s.z, (float)q.w * s.w);",
     "  return make_float4((float)q.x * s.x, (float)q.y * s.x, (float)q.z * s.z, (float)q.w * s.z);"),
    ("a grid barrier dropped (fc partials read before they are complete)", "decode_fused.cuh",
     "  barrier(grid);  // fc partials complete",
     ""),
    ("the new K/V row written into the next beam slot", "attend.cuh",
     "    const size_t dst = (((size_t)own * B + b) * Lpad + pos) * D + hoff + t;",
     "    const size_t dst = (((size_t)((own + 1) % K) * B + b) * Lpad + pos) * D + hoff + t;"),
    ("split partials summed in reverse order (within each group of eight)", "decode_fused.cuh",
     "    for (int j = 0; j < 8; ++j) if (s0 + j < S) v += x[j];",
     "    for (int j = 7; j >= 0; --j) if (s0 + j < S) v += x[j];"),
    ("new bf16 K/V row truncated, not rounded to nearest", "attend.cuh",
     "__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }",
     "__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rz(v); }"),
    ("bf16 q.k products summed unrounded", "attend.cuh",
     "  return acc + __bfloat162float(__float2bfloat16_rn(q * __bfloat162float(k)));",
     "  return fmaf(q, __bfloat162float(k), acc);"),
    ("bf16 scaled query not rounded to bf16", "attend.cuh",
     "  return __bfloat162float(__float2bfloat16_rn(x));",
     "  return x;"),
    ("a vocabulary shard's raw scores minus its own log-sum-exp", "head_select.cuh",
     "  const float lse = partial ? 0.f : mx + logf(se);  // partial: raw logits out",
     "  const float lse = mx + logf(se);"),
    ("sum-exp not rescaled to the block max", "head_select.cuh",
     "  const float se = block_sum(m == -INFINITY ? 0.f : z * expf(m - mx), red);",
     "  const float se = block_sum(m == -INFINITY ? 0.f : z, red);"),
    ("a shard narrower than K: 0, not -1e30, past its width", "head_select.cuh",
     "        sc[(size_t)r * K + k] = -1e30f;",
     "        sc[(size_t)r * K + k] = 0.f;"),
    ("forward sweep without its cluster barrier", "bilstm.cu",
     ("    cluster_arrive();  // this block's h slice is in every peer",
      "    cluster_wait();  // every peer's slice is here, and every peer has read h_{t-1}"),
     ("", "")),
    ("h slice sent one unit off", "bilstm.cu",
     "      const float4* src = reinterpret_cast<const float4*>(hnext + j0 * BT);",
     "      const float4* src = reinterpret_cast<const float4*>(hnext + (j0 + 1) * BT);"),
    ("a masked row sends its new h, not its kept h", "bilstm.cu",
     "      hnext[j * BT + r] = h[i];  // a masked row sends its kept h",
     "      hnext[j * BT + r] = hn;"),
    ("dh pieces added out of rank order", "bilstm_bwd.cu",
     "        for (int q = 0; q < C; ++q) a += rv[(q * U + iu[m]) * BT + ir[m]];",
     "        for (int q = C - 1; q >= 0; --q) a += rv[(q * U + iu[m]) * BT + ir[m]];"),
    ("attention fill from one key past lens_k", "las_fused.cu",
     "      s = t >= len ? MASK_FILL : s;",
     "      s = t > len ? MASK_FILL : s;"),
    ("head ties resolved to the highest index", "las_fused.cu",
     "    if (better(ov, oi, v, i)) {",
     "    if (ov > v || (ov == v && oi > i)) {"),
    ("residual on layer 0 of the teacher-forced scan", "las_fused.cu",
     "            float y = l == 1 ? h + xt[(size_t)b * xw + u] : h;",
     "            float y = l <= 1 ? h + xt[(size_t)b * xw + u] : h;"),
    ("context dropout mask dropped", "las_fused.cu",
     "    if (a.mctx) v *= a.mctx[(size_t)b * Ha2 + d];",
     ""),
    ("a grid barrier dropped (K2's FFN reads the context before it is complete)",
     "las_fused.cu",
     "    barrier(grid);  // every row's context complete",
     ""),
    ("a narrow item's warp partials summed in reverse order", "las_fused.cu",
     "    for (int q = 0; q < WARPS; ++q) v += red[q * BM * NJ + threadIdx.x];",
     "    for (int q = WARPS - 1; q >= 0; --q) v += red[q * BM * NJ + threadIdx.x];"),
    ("gc[t] dropped from the backward's layer-0 product", "las_fused.cu",
     "          a.dcell[e] = v + a.g_cell[e];",
     "          a.dcell[e] = v;"),
    ("the PAD symbol's embedding row read", "las_fused.cu",
     "    return o.p0 && id != STJEP_PAD ? o.p0 + (size_t)id * o.ld0 + k : nullptr;",
     "    return o.p0 ? o.p0 + (size_t)id * o.ld0 + k : nullptr;"),
    ("K6c adds b_2 and x under partial_tp", "decode_fused.cu",
     "  a.add = !partial_tp;",
     "  a.add = 1;", SELECT_TP),
    ("K6a's heads as wide as a full-width head (D / nh, not Dq / nh)", "decode_fused.cu",
     "  c.d = Dq / nh;\n  c.aw = step_warps(smem, c.d, Lpad);",
     "  c.d = D / nh;\n  c.aw = step_warps(smem, c.d, Lpad);", SELECT_TP),
    ("K6c (and K5): b_1 dropped from w2's operand", "decode_fused.cuh",
     "        v = psum(j.A, j.SA, M, j.Kd, gm, gk) + j.abias[gk];",
     "        v = psum(j.A, j.SA, M, j.Kd, gm, gk);", SELECT_TP),
    ("K6b's LayerNorm scaled by its bias", "decode_fused.cu",
     "  a.L.v[LN2G] = ln_g;",
     "  a.L.v[LN2G] = ln_b;", SELECT_TP),
    ("K6a's new K/V row written and read at pos + 1", "decode_fused.cu",
     "  c.Lpad = Lpad;\n  c.pos = pos;\n  c.anc = anc;\n  c.maskk = maskk;\n  c.tiles",
     "  c.Lpad = Lpad;\n  c.pos = pos + 1 < Lpad ? pos + 1 : pos - 1;\n  c.anc = anc;\n"
     "  c.maskk = maskk;\n  c.tiles", SELECT_TP),
    ("K3's first row phase takes LN2 of its input, not LN1", "decode_chain.cu",
     "  row_phase(c, nullptr, 0, nullptr, a.x, c.X0, a.L.v[LN1G], a.L.v[LN1B], 1e-6f, red);",
     "  row_phase(c, nullptr, 0, nullptr, a.x, c.X0, a.L.v[LN2G], a.L.v[LN2B], 1e-6f, red);",
     SELECT_CHAIN),
    ("K3's every layer attends over layer 0's memory K", "decode_chain.cu",
     "                       (const CT*)a.mk + l * mem_layer, (const CT*)a.mv + l * mem_layer,",
     "                       (const CT*)a.mk, (const CT*)a.mv + l * mem_layer,", SELECT_CHAIN),
    ("K3's gather ids dropped (glp read at no id)", "decode_chain.cu",
     "  topk_rows(c, a.V, a.topk, a.gid, a.sc, a.ids, a.glp, nullptr, nullptr);",
     "  topk_rows(c, a.V, a.topk, nullptr, a.sc, a.ids, a.glp, nullptr, nullptr);",
     SELECT_CHAIN),
    ("K3's and K7c's logits summed over one split fewer", "decode_chain.cu",
     "      c.LG[(size_t)r * V + v] = psum(c.PA, SD, c.BK, V, r, v);",
     "      c.LG[(size_t)r * V + v] = psum(c.PA, SD - 1, c.BK, V, r, v);", SELECT_CHAIN),
    ("K7c's LayerNorm scaled by its bias", "decode_chain.cu",
     "  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.norm_g, a.norm_b, 1e-5f, red);",
     "  row_phase(c, nullptr, 0, nullptr, a.x, nullptr, a.norm_b, a.norm_b, 1e-5f, red);",
     SELECT_CHAIN),
    ("K7c's top-K reads the head partials before they are complete", "decode_chain.cu",
     "  barrier(grid);  // the shard's head partials complete",
     "", SELECT_CHAIN),
]


def run(workdir: Path, label: str, mutation=None) -> int:
    """Copy, mutate, build and test; returns pytest's exit code."""
    dst = workdir / label.replace(" ", "_")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "stjep_tpu_torch", dst / "stjep_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (dst / "tests").mkdir(parents=True)
    shutil.copy(ROOT / "tests" / "test_torch_cuda.py", dst / "tests")
    select = SELECT
    if mutation is not None:
        _, name, old, new = mutation[:4]
        src = dst / "stjep_tpu_torch" / "csrc" / name
        text = src.read_text()
        pairs = zip(old, new) if isinstance(old, tuple) else [(old, new)]
        for o, n in pairs:
            if text.count(o) != 1:
                raise RuntimeError(f"mutation site not found once: {o!r}")
            text = text.replace(o, n)
        src.write_text(text)
        select = (mutation[4] if len(mutation) > 4 else SELECT_BILSTM
                  if name.startswith("bilstm") else SELECT_LAS if name == "las_fused.cu"
                  else SELECT)
    env = {**os.environ, "PYTHONPATH": str(dst)}
    cmd = [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda",
           "--noconftest", "-q", "-p", "no:cacheprovider", "-k",
           select if mutation is not None else f"{SELECT} or {SELECT_BILSTM} or {SELECT_LAS}"]
    try:
        proc = subprocess.run(cmd, cwd=dst, env=env, capture_output=True, text=True,
                              timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"[{label}] timed out after {TIMEOUT_S} s", flush=True)
        return 124
    lines = proc.stdout.strip().splitlines()
    print(f"[{label}] rc={proc.returncode} {lines[-1] if lines else proc.stderr[-500:]}",
          flush=True)
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", type=Path,
                    default=ROOT / "stjep_tpu_torch" / "build" / "mutants")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    args.workdir.mkdir(parents=True, exist_ok=True)
    if run(args.workdir, "unchanged") != 0:
        print("the unchanged copy fails its tests", flush=True)
        return 1
    chosen = [(i, m) for i, m in enumerate(MUTATIONS)
              if any(part in m[1] or part in m[0] for part in args.only.split(","))]
    survived = [m[0] for i, m in chosen if run(args.workdir, f"mutation {i}", m) == 0]
    print(f"mutants caught: {len(chosen) - len(survived)} of {len(chosen)}; "
          f"not caught: {survived}", flush=True)
    shutil.rmtree(args.workdir, ignore_errors=True)
    return 1 if survived else 0


if __name__ == "__main__":
    sys.exit(main())
