#!/usr/bin/env python3
"""Profile the port's decode paths at the flagship on one GPU.

    python3 stjep_tpu_torch/scripts/profile_decode.py [--seed 0] [--n_model N] [--train]
        [--train_loop] [--act]

The paths are chip_smoke.py's (its flagship workload is flagship.py's): ST beam-5 (forward_translate) and dev eval
(forward_eval ASR_ST with reference ids), each on the standard and on the
universal transformer, at B=16 with random weights; and the serving decode,
ST beam-5 on the standard model with bf16 caches and int8 weights, at B=16
and at B=1. With --n_model N > 1 only the ST beam-5 on the standard
model, tensor-parallel on a (1, N) mesh whose shards all lie on the card
(parallel/spmd.py). With --train only the ASR_ST train step at the
flagship (make_train_step, B=16, dropout and SpecAugment on, as
chip_smoke.py's train e2e phase), one step a call. With --train_loop
only the Trainer's epoch loop (train/trainer.py) against the bare step at
the same shapes, on a corpus written like chip_smoke.py's train cli one
(320 utterances of 1504 frames, B=16: 20 steps an epoch): f32 with
per-step staging, bf16 (--dtype bfloat16), and the int8 device cache with
--train_window 1 and 4, each timed over 3 interleaved epochs after a
warm-up epoch (`train_loop`), then one epoch a call profiled. With --act
only chip_smoke.py's act and dense eval paths: the ACT ST beam-5 and ACT
dev eval (universal + ACT, B=16, each position re-running the token
buffer), forward_eval ASR_ST without refs on the standard model (the
dense greedy), and the ASR_ST train step with and without cfg.remat. For each path: one
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
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from stjep_tpu_torch.scripts import flagship as cs  # noqa: E402
from stjep_tpu_torch.utils import trace_tools  # noqa: E402
from stjep_tpu_torch.utils.profiling import launch_counts, zero_launch_counts  # noqa: E402


# device kernels that only a decode position launches; the decode loop's
# window on the device runs from the first to the last of them
STEP_KERNELS = ("layer_kernel", "beam_kernel", "chain_kernel", "head_full_kernel",
                "beam_select", "self_step_kernel", "cross_step_kernel", "ffn_step_kernel",
                "head_step_kernel")


def positions(n_model: int) -> int:
    """Decode positions since zero_launch_counts(): each runs one head (K3,
    K4, or K7 and its gather variant; K7c once per shard)."""
    got = launch_counts()
    single = sum(v for k, v in got.items()
                 if k.split()[0] in ("K3", "K4") and k != "K4 select"
                 or k in ("K7 head", "K7 head_gather"))
    return single + got["K7 head_partial"] // n_model


def profile(label: str, fn, n_model: int = 1, n_steps: int = 0, count_positions=None):
    """count_positions: the decode positions the call ran, from the launch
    counts (`positions` by default)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    zero_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n_pos = count_positions() if count_positions else positions(n_model)
    events = prof.events()
    dev = trace_tools.device_ops(events)
    reading = trace_tools.profile_reading(events, wall)
    host_ops, busy = reading["host_aten_ops"], reading["busy_ms"]
    steps = [e.time_range for e in dev if any(k in e.name for k in STEP_KERNELS)]
    per_pos = {}
    if steps and n_pos:
        a, b = min(r.start for r in steps), max(r.end for r in steps)
        in_loop = sum(1 for e in dev if a <= e.time_range.start < b)
        per_pos = dict(positions=n_pos, loop_device_ops=in_loop,
                       device_ops_per_position=round(in_loop / n_pos, 2))
    if n_steps:
        per_pos = dict(steps=n_steps, steps_per_s=round(n_steps * 1e3 / plain_wall, 3),
                       host_aten_ops_per_step=round(host_ops / n_steps, 1))
    cs.say(f"profile {label}", wall_ms=round(plain_wall, 3), profiled_wall_ms=round(wall, 3),
           device_busy_ms=round(busy, 3), idle_share=round(1 - busy / wall, 4),
           device_ops=len(dev), host_aten_ops=host_ops, **per_pos)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {name[:70]:70s} {ms:10.3f} ms  x{n}", flush=True)


# the --train_loop corpus: train utterances (20 steps an epoch at B = 16),
# every one cs.FRAMES frames, and the timed rounds
LOOP_UTTS = 320
LOOP_ROUNDS = 3


def train_loop(seed: int):
    """The Trainer's epoch loop against the bare step at the same shapes.
    Four loops, each a Trainer of its own on one corpus: f32 with per-step
    staging (native loader, pinned copies in the prefetch thread), bf16
    (--dtype bfloat16), and the int8 device cache with --train_window 1 and
    4; and the bare step (make_train_step, no loader, no loop) in f32 and
    bf16 on the f32 loop's first staged batch. Each is warmed by one epoch
    (kernel builds, the cache, the first steps). Then LOOP_ROUNDS rounds,
    each timing one epoch of every loop and an epoch's count of bare steps
    in turn on the host clock (an epoch's batch shuffle and prefetch start
    included, checkpoint writes left out), with the time the loop waited
    on its prefetch queue. Then one epoch of the f32, bf16 and window-4
    loops under torch.profiler."""
    import tempfile

    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.data.dataset import Dataset
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.train import trainer as T
    from stjep_tpu_torch.train.optim import make_optimizer

    cfg = ModelConfig(**cs.FLAGSHIP)
    waited = [0.0]
    prefetch = T.host_prefetch

    def timed_prefetch(it, size=2):  # the loop's time blocked on staging
        src = prefetch(it, size=size)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(src)
            except StopIteration:
                return
            finally:
                waited[0] += time.perf_counter() - t0
            yield item

    T.host_prefetch = timed_prefetch
    with tempfile.TemporaryDirectory(prefix="stjep_profile_loop_") as tmp:
        t0 = time.perf_counter()
        corpus = cs.write_corpus(Path(tmp) / "corpus", seed, utts={"train": LOOP_UTTS},
                                 frames=(cs.FRAMES, cs.FRAMES))
        cs.say("train loop corpus", utterances=LOOP_UTTS, frames=cs.FRAMES, B=cs.B,
               write_s=round(time.perf_counter() - t0, 3))
        ways = {"f32": (torch.float32, {}),
                "bf16": (torch.bfloat16, {"feat_dtype": "bfloat16"}),
                "int8 cache window 1": (torch.float32, {"feat_dtype": "int8",
                                                        "device_cache": True, "train_window": 1}),
                "int8 cache window 4": (torch.float32, {"feat_dtype": "int8",
                                                        "device_cache": True, "train_window": 4})}
        runs = {}
        for label, (dtype, opts) in ways.items():
            opts = dict(opts)
            t = T.Trainer_ASR_ST(expt_dir=str(Path(tmp) / label.replace(" ", "_")),
                                 batch_size=cs.B, learning_rate=cs.TRAIN_LR,
                                 learning_rate_init=cs.TRAIN_LR, lr_warmup_steps=0, seed=seed,
                                 print_every=10 ** 9, checkpoint_every=10 ** 9,
                                 loss_coeff={"nll_asr": 1.0, "nll_st": 1.0},
                                 device_cache=opts.pop("device_cache", False), device="cuda",
                                 **opts)
            t._save = lambda *a, **kw: None  # checkpoint writes are not the loop's
            ds = Dataset(path_src=corpus["train_src"], path_tgt=corpus["train_tgt"],
                         path_vocab_src=corpus["vocab_src"], path_vocab_tgt=corpus["vocab_tgt"],
                         acous_path=corpus["train_flis"], acous_norm_path=corpus["norm"],
                         acous_norm=True, max_seq_len_src=cfg.max_seq_len_src,
                         max_seq_len_tgt=cfg.max_seq_len_tgt, batch_size=cs.B, mode="ST",
                         seed=seed, acous_max_len=3000)  # train.py's --las_acous_max_len
            params = init_seq2seq(cfg, torch.Generator().manual_seed(seed), device="cuda",
                                  dtype=dtype)
            params, opt_state, _, _ = t.setup(params, cfg)
            runs[label] = (lambda t=t, ds=ds, p=params, o=opt_state:
                           t._train_epoches({"st": ds}, cfg, p, o, 1, 1, 0), t)
            if label == "f32":
                ds.construct_batches(is_train=False)
                macro = t._stage_batch(ds.materialise_batch(0))[0]
                n_steps = len(ds)
        mb = {k: v[0] for k, v in macro.items()}
        for label, dtype in (("bare f32", torch.float32), ("bare bf16", torch.bfloat16)):
            p = init_seq2seq(cfg, torch.Generator().manual_seed(seed), device="cuda", dtype=dtype)
            opt = make_optimizer(1.0)
            state = {"p": p, "o": opt.init(p)}
            step = T.make_train_step(cfg, "ASR_ST", opt, device="cuda")
            bmb = dict(mb, acous_feat=mb["acous_feat"].to(dtype))
            gen = torch.Generator().manual_seed(seed)

            def bare(step=step, state=state, bmb=bmb, gen=gen):
                for _ in range(n_steps):
                    state["p"], state["o"], _ = step(state["p"], state["o"], [bmb], gen,
                                                     cs.TRAIN_LR)
            runs[label] = (bare, None)
        cs.say("train loop shapes", steps_an_epoch=n_steps,
               acous_feat=list(mb["acous_feat"].shape), srcid=list(mb["srcid"].shape),
               tgtid=list(mb["tgtid"].shape))
        for fn, _ in runs.values():  # warm-up: one epoch each
            fn()
        torch.cuda.synchronize()
        rates = {label: [] for label in runs}
        waits = {label: [] for label in runs}
        for _ in range(LOOP_ROUNDS):
            for label, (fn, t) in runs.items():
                n0, waited[0] = (t.steps_run if t else 0), 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                n = t.steps_run - n0 if t else n_steps
                rates[label].append(n / dt)
                waits[label].append(waited[0] * 1e3 / n)
        for label, r in rates.items():
            bare = rates["bare bf16" if label in ("bf16", "bare bf16") else "bare f32"]
            cs.say(f"train loop timing {label}", steps_per_round=n_steps,
                   steps_per_s=r, median_steps_per_s=float(np.median(r)),
                   of_bare_step=[a / b for a, b in zip(r, bare)],
                   prefetch_wait_ms_a_step=waits[label])
        for label in ("f32", "bf16", "int8 cache window 4"):
            profile(f"train loop {label}", runs[label][0], n_steps=n_steps)
    T.host_prefetch = prefetch


def act_paths(seed: int, rng, f, l):
    """chip_smoke.py's phase 10 paths under the profiler (module docstring)."""
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import BOS, ModelConfig
    from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.ops.decode_flash import beam_select, decoder_layer_step_flash
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.trainer import make_train_step

    acfg = ModelConfig(**{**cs.FLAGSHIP, "transformer_type": "universal", "act": True})
    aparams = params_to(init_seq2seq(acfg, torch.Generator().manual_seed(seed + 5), "cpu"),
                        "cuda")
    refs = {"ref_src": rng.randint(5, acfg.enc_vocab_size, (cs.B, acfg.max_seq_len_src)),
            "ref_tgt": rng.randint(5, acfg.dec_vocab_size, (cs.B, acfg.max_seq_len_tgt))}
    refs = {k: torch.from_numpy(v).cuda() for k, v in refs.items()}
    for r in refs.values():
        r[:, 0] = BOS
    profile("act beam", lambda: forward_translate(
        aparams, acfg, "ST", acous_feats=f, acous_lens=l, beam_width=cs.BEAM,
        penalty_factor=1.0, max_seq_len=cs.DECODE_LEN, device="cuda"),
        count_positions=lambda: beam_select.launches + 1)
    profile("act dev_eval", lambda: forward_eval(aparams, acfg, "ASR_ST", acous_feats=f,
                                                 acous_lens=l, **refs))
    cfg = ModelConfig(**cs.FLAGSHIP)
    init = init_seq2seq(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = params_to(init, "cuda")
    profile("standard dense eval, no refs", lambda: forward_eval(
        params, cfg, "ASR_ST", acous_feats=f, acous_lens=l),
        count_positions=lambda: decoder_layer_step_flash.launches // cfg.dec_layers)
    mb = {k: v.cuda() for k, v in cs.train_batch(rng, cfg, cs.B, cs.FRAMES).items()}
    for remat in (False, True):
        c = ModelConfig(**cs.FLAGSHIP, remat=remat)
        state = {"params": params_to(init, "cuda")}
        opt = make_optimizer(1.0)
        state["opt"] = opt.init(state["params"])
        step = make_train_step(c, "ASR_ST", opt, device="cuda")
        gen = torch.Generator().manual_seed(seed)

        def one_step(step=step, state=state, gen=gen):
            state["params"], state["opt"], _ = step(state["params"], state["opt"], [mb], gen,
                                                    cs.TRAIN_LR)
        one_step()  # a second warm-up step: the first builds the optimizer's state
        torch.cuda.reset_peak_memory_stats()
        profile(f"train step ASR_ST remat={remat}", one_step)
        cs.say(f"train step ASR_ST remat={remat} memory",
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del state
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_model", type=int, default=1,
                    help="> 1: profile the tensor-parallel beam on a (1, N) mesh of the card")
    ap.add_argument("--train", action="store_true", help="profile the train step alone")
    ap.add_argument("--train_loop", action="store_true",
                    help="profile the Trainer's epoch loop alone (f32, bf16, int8 window)")
    ap.add_argument("--act", action="store_true",
                    help="profile ACT decode and dev eval, the dense eval, the remat step")
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
    if args.train_loop:
        train_loop(args.seed)
        return 0
    if args.act:
        act_paths(args.seed, rng, feats.cuda(), lens.cuda())
        return 0
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
