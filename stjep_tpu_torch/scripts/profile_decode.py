#!/usr/bin/env python3
"""Profile the port's decode paths at the flagship on one GPU.

    python3 stjep_tpu_torch/scripts/profile_decode.py [--seed 0] [--n_model N] [--train]

The paths are chip_smoke.py's: ST beam-5 (forward_translate) and dev eval
(forward_eval ASR_ST with reference ids), each on the standard and on the
universal transformer, at B=16 with random weights; and the serving decode,
ST beam-5 on the standard model with bf16 caches and int8 weights, at B=16
and at B=1. With --n_model N > 1 only the ST beam-5 on the standard
model, tensor-parallel on a (1, N) mesh whose shards all lie on the card
(parallel/spmd.py). With --train only the ASR_ST train step at the
flagship (make_train_step, B=16, dropout and SpecAugment on, as
chip_smoke.py's train e2e phase), one step a call. For each path: one
warm-up call, one call timed on the host clock, then one call under
torch.profiler. Prints per path the plain wall ms, the profiled wall ms
(inflated by the profiler), device busy ms (the union of the device
intervals), the idle share (1 - busy / profiled wall), the number of device
operations and of host-side PyTorch operators, the decode positions the
call ran (from the kernels' launch counts) and the device operations per
position (those that start between the first and the last decode-step
kernel: the fused K3, K4, K5, K6a-c, K7 and K7c, the select), and the
eight device kernels with the most time.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


# device kernels that only a decode position launches; the decode loop's
# window on the device runs from the first to the last of them
STEP_KERNELS = ("layer_kernel", "beam_kernel", "chain_kernel", "head_full_kernel",
                "beam_select", "self_step_kernel", "cross_step_kernel", "ffn_step_kernel",
                "head_step_kernel")


def positions(n_model: int) -> int:
    """Decode positions since cs.zero_counts(): each runs one head (K3,
    K4, or K7 and its gather variant; K7c once per shard)."""
    got = {k: getattr(fn, attr) for k, (fn, attr) in cs.counters().items()}
    single = sum(v for k, v in got.items()
                 if k.split()[0] in ("K3", "K4") and k != "K4 select"
                 or k in ("K7 head", "K7 head_gather"))
    return single + got["K7 head_partial"] // n_model


def profile(label: str, fn, n_model: int = 1):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cs.zero_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n_pos = positions(n_model)
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host_ops = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("aten::"))
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in dev)
    steps = [e.time_range for e in dev if any(k in e.name for k in STEP_KERNELS)]
    per_pos = {}
    if steps and n_pos:
        a, b = min(r.start for r in steps), max(r.end for r in steps)
        in_loop = sum(1 for e in dev if a <= e.time_range.start < b)
        per_pos = dict(positions=n_pos, loop_device_ops=in_loop,
                       device_ops_per_position=round(in_loop / n_pos, 2))
    cs.say(f"profile {label}", wall_ms=round(plain_wall, 3), profiled_wall_ms=round(wall, 3),
           device_busy_ms=round(busy, 3), idle_share=round(1 - busy / wall, 4),
           device_ops=len(dev), host_aten_ops=host_ops, **per_pos)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {name[:70]:70s} {ms:10.3f} ms  x{n}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_model", type=int, default=1,
                    help="> 1: profile the tensor-parallel beam on a (1, N) mesh of the card")
    ap.add_argument("--train", action="store_true", help="profile the train step alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA device", file=sys.stderr)
        return 2
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import BOS, ModelConfig
    from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.parallel.mesh import make_mesh
    from stjep_tpu_torch.parallel.spmd import set_kernel_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    rng = np.random.RandomState(args.seed)
    feats, lens = cs.inputs(rng, cs.B)
    if args.train:
        from stjep_tpu_torch.train.optim import make_optimizer
        from stjep_tpu_torch.train.trainer import make_train_step

        cfg = ModelConfig(**cs.FLAGSHIP)
        state = {"params": params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed),
                                                  "cpu"), "cuda")}
        mb = {k: v.cuda() for k, v in cs.train_batch(rng, cfg, cs.B, cs.FRAMES).items()}
        opt = make_optimizer(1.0)
        state["opt"] = opt.init(state["params"])
        step = make_train_step(cfg, "ASR_ST", opt, device="cuda")
        gen = torch.Generator().manual_seed(args.seed)

        def one_step():
            state["params"], state["opt"], _ = step(state["params"], state["opt"], [mb], gen,
                                                    cs.TRAIN_LR)
        one_step()  # a second warm-up step: the first builds the optimizer's state
        profile("train step ASR_ST", one_step)
    if args.n_model > 1:
        cfg = ModelConfig(**cs.FLAGSHIP)
        params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu"),
                           "cuda")
        f, l = feats.cuda(), lens.cuda()
        set_kernel_mesh(make_mesh(1, args.n_model, ["cuda"] * args.n_model))
        profile(f"standard beam tp n={args.n_model}", lambda: forward_translate(
            params, cfg, "ST", acous_feats=f, acous_lens=l, beam_width=cs.BEAM,
            penalty_factor=1.0, max_seq_len=cs.DECODE_LEN, device="cuda"), args.n_model)
        set_kernel_mesh(None)
    for kind in ("standard", "universal") if args.n_model == 1 and not args.train else ():
        cfg = ModelConfig(**{**cs.FLAGSHIP, "transformer_type": kind})
        params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu"),
                           "cuda")
        refs = {"ref_src": torch.from_numpy(rng.randint(5, cfg.enc_vocab_size,
                                                        (cs.B, cfg.max_seq_len_src))),
                "ref_tgt": torch.from_numpy(rng.randint(5, cfg.dec_vocab_size,
                                                        (cs.B, cfg.max_seq_len_tgt)))}
        for r in refs.values():
            r[:, 0] = BOS
        f, l = feats.cuda(), lens.cuda()
        refs = {k: v.cuda() for k, v in refs.items()}
        profile(f"{kind} beam", lambda: forward_translate(
            params, cfg, "ST", acous_feats=f, acous_lens=l, beam_width=cs.BEAM,
            penalty_factor=1.0, max_seq_len=cs.DECODE_LEN, device="cuda"))
        profile(f"{kind} dev_eval", lambda: forward_eval(
            params, cfg, "ASR_ST", acous_feats=f, acous_lens=l, **refs))
        if kind == "standard":
            for n in (cs.B, 1):
                fn, ln = f[:n], l[:n]
                profile(f"standard serving int8+bf16 B={n}", lambda: forward_translate(
                    params, cfg, "ST", acous_feats=fn, acous_lens=ln, beam_width=cs.BEAM,
                    penalty_factor=1.0, max_seq_len=cs.DECODE_LEN, device="cuda",
                    cache_dtype=torch.bfloat16, weight_dtype="int8"))
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
