#!/usr/bin/env python3
"""Where a launch of the fused K5, K4, K2, K9 and K7 goes, phase by phase, on one GPU.

    python3 stjep_tpu_torch/scripts/fused_phase_split.py [--seed 0] [--reps 20] [--only decode,las,head]

At chip_smoke.py's flagship shapes: K5 and K4 at B=16, beam 5, position 75
of 160 cache rows, 96 memory rows, f32 on the full grid and on one block per
SM (132), and int8 weights with bf16 caches; K2 over 89 steps at B=16, 188
keys and 30 000 ids, and K9's forward and backward over 89 steps, each on
the full grid; with --only head, K7 (decode_head at BK = 80, top-5, and
decode_head_gather at BK = 16, top-1, at V = 200 and 30 000; K7's phases
row, head, slice and past 2048 ids merge). The script builds the kernel library with
-DSTJEP_FUSED_STAMPS (a library of its own; the default build has no timer
reads), and each launch then records the global timer at its start and
after every grid barrier (csrc/decode_fused.cu `stamp`,
`decode_fused_stamps`; csrc/decode_chain.cu `decode_chain_stamps`;
csrc/las_fused.cu `las_fused_stamps`, whose launches
first pass 4 barriers that guard no work: `bare` below, a barrier's own
cost). Prints, per launch kind, the grid and the launch's time from CUDA
events, and the median microseconds of each phase kind summed over the
launch (qkv, self, fc, row, cq, cross, co, w1, w2; K4 also embed, head and
select; K2 and K9 lstm, att, ffn, head, outputs, ffn_t, lstm_t, l0_t, and
for them also per step and per phase). The last phase, which no barrier
closes, is the event time less the stamped span, so it carries the launch
overhead. For K2 and K9 also a timeline of a middle step: each phase's us
and when block 0's item started, had its first chunk and had multiplied
its last (`item_stamp` in csrc/las_fused.cu).
"""

from __future__ import annotations

import argparse
import statistics
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402


def timeline(label, fn, plan, step, per_step):
    """One launch of a fused K2 / K9 with block 0's item stamps on: for the
    phases of step `step`, each phase's us and, inside it, when block 0's
    item started (1), had its first chunk in shared memory (2) and had
    multiplied its last chunk (3), in us after the barrier that opened it."""
    from stjep_tpu_torch import kernels

    n = plan["barriers"] + 4
    stamps = torch.zeros(2 + n, dtype=torch.int64, device="cuda")
    items = torch.zeros(1 + 2 * 65536, dtype=torch.int64, device="cuda")
    kernels.launch("las_fused_stamps", stamps, items)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernels.launch("las_fused_stamps", None, None)
    bar = stamps.cpu().numpy()[1:2 + n]
    it = items.cpu().numpy()
    k = int(it[0])
    tags, times = it[1:1 + 2 * k:2], it[2:2 + 2 * k:2]
    phases = [("bare", 0)] * 4 + list(plan["phases"])
    out = []
    for j in range(4 + step * per_step, 4 + (step + 1) * per_step):
        a, b = bar[j], bar[j + 1]
        inside = [f"{int(g)}@{(t - a) / 1e3:.2f}" for g, t in zip(tags, times) if a <= t < b]
        out.append(f"{phases[j][0]}:{(b - a) / 1e3:.2f}us[{' '.join(inside)}]")
    cs.say(f"timeline {label} step={step}", phases=" ".join(out))


def split(label, fn, plan, reps, entry="decode_fused_stamps", bare=0, steps=0):
    """Run fn reps times with stamps on; print the phase kinds' medians
    (with steps, also per step and per phase)."""
    from stjep_tpu_torch import kernels

    phases = [("bare", 0)] * bare + list(plan["phases"])
    n = plan["barriers"] + bare
    stamps = torch.zeros(2 + n, dtype=torch.int64, device="cuda")
    extra_args = (None,) if entry == "las_fused_stamps" else ()
    kernels.launch(entry, stamps, *extra_args)
    fn()
    per_kind, totals = defaultdict(list), []
    try:
        for _ in range(reps):
            stamps.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total = a.elapsed_time(b) * 1e3
            st = stamps.cpu().numpy()
            assert st[0] == 1 + n, st[0]
            times = np.diff(st[1:2 + n]) / 1e3
            sums = defaultdict(float)
            for (kind, _), t in zip(phases, times):
                sums[kind] += t
            sums[phases[-1][0]] += total - (st[1 + n] - st[1]) / 1e3
            for k, v in sums.items():
                per_kind[k].append(v)
            totals.append(total)
    finally:
        kernels.launch(entry, None, *extra_args)
    med = {k: round(statistics.median(v), 2) for k, v in per_kind.items()}
    extra = {}
    if steps:
        count = defaultdict(int)
        for kind, _ in phases:
            count[kind] += 1
        extra = dict(us_by_phase_per_step={k: round(v / steps, 3) for k, v in med.items()
                                           if k not in ("bare", "outputs")},
                     us_a_phase={k: round(v / count[k], 3) for k, v in med.items()})
    cs.say(f"phases {label}", launch_us=round(statistics.median(totals), 2),
           barriers=n, us_by_phase=med, **extra)


def split_head(args, params, cfg, rng):
    """K7 at the universal paths' shapes and at a word-level vocabulary."""
    from stjep_tpu_torch.ops import decode_flash as df

    D, norm = cfg.dim_model, params["dec_tgt"]["norm"]
    big = {"w": torch.from_numpy((rng.randn(D, 30000) / np.sqrt(D)).astype(np.float32)).cuda()}
    for V, out in ((cfg.dec_vocab_size, params["out_tgt"]), (30000, big)):
        for BK, topk in ((cs.B * cs.BEAM, cs.BEAM), (cs.B, 1)):
            x = torch.from_numpy(rng.randn(BK, D).astype(np.float32)).cuda()
            gid = torch.from_numpy(rng.randint(0, V, BK).astype(np.int32)).cuda()
            plan = df.fused_plan(BK, D, 0, 1, 0, 0, V=V, step="full_head")
            fn = ((lambda: df.decode_head(norm, out, x, topk)) if topk > 1 else
                  (lambda: df.decode_head_gather(norm, out, x, topk, gid)))
            split(f"K7 V={V} BK={BK}", fn, plan, args.reps, entry="decode_chain_stamps")


def split_las(args, params, cfg, rng):
    """K2 and K9 at chip_smoke.py's flagship shapes, on the full grid."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.ops import las_tf_flash as k9
    from stjep_tpu_torch.ops.attention import precompute_keys
    from stjep_tpu_torch.ops.las_flash import las_greedy_flash, las_grid, las_plan

    dec = params["las"]["decoder"]
    B, Tk, n = cs.B, cs.FRAMES // 8, cfg.max_seq_len_src - 1
    Hd, Ha2, E = cfg.dim_model, 2 * cfg.acous_hidden_size, cfg.enc_embedding_size
    acous = torch.from_numpy(rng.uniform(-1, 1, (B, Tk, Ha2)).astype(np.float32)).cuda()
    wk = precompute_keys(dec["acous_att"], acous, "bilinear")["wk"]
    lens = torch.from_numpy(rng.randint(Tk // 2, Tk + 1, size=(B,))).cuda()
    args2 = (dec, cfg, wk, acous, lens, torch.full((B,), BOS, device="cuda"), n)
    plan = las_plan("greedy", B, Tk, Hd, Hd, Ha2, E=E, V=cfg.enc_vocab_size,
                    nl=cfg.num_unilstm_dec, steps=n)
    grid = las_grid("greedy", plan["smem"])["blocks"]
    split(f"K2 grid={grid}", lambda: las_greedy_flash(*args2), plan, args.reps,
          "las_fused_stamps", 4, n)
    timeline("K2", lambda: las_greedy_flash(*args2), plan, n // 2, cfg.num_unilstm_dec + 3)
    w = k9.scan_weights(*(dec[k][nm] for k, nm in (
        ("dec_l0", "w_ih"), ("dec_l0", "w_hh"), ("dec_l1", "w_ih"), ("dec_l1", "w_hh"),
        ("dec_l1", "b_ih"), ("dec_l1", "b_hh"), ("dec_l2", "w_ih"), ("dec_l2", "w_hh"),
        ("dec_l2", "b_ih"), ("dec_l2", "b_hh"))), dec["acous_ffn"]["w"], pack=True)
    ids = torch.from_numpy(rng.randint(5, cfg.enc_vocab_size, (n, B))).cuda()
    p0 = dec["dec_l0"]
    pre0 = (dec["embedder"][ids] @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]).contiguous()
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    masks = k9.Masks(t((rng.rand(n, 3, B, Hd) < 0.8) / 0.8), t((rng.rand(n, B, Ha2) < 0.8) / 0.8))
    wk9 = (acous @ dec["acous_att"]["linear_att_w"]["w"]).contiguous()
    fargs = (w, pre0, wk9, acous, lens, masks)
    st = k9.las_tf_fwd(*fargs)
    g = t(rng.randn(n, B, Hd))
    for kind, fn in (("tf_fwd", lambda: k9.las_tf_fwd(*fargs)),
                     ("tf_bwd", lambda: k9.las_tf_bwd(w, st, g, wk9, acous, masks))):
        plan = las_plan(kind, B, Tk, Hd, Hd, Ha2, steps=n)
        grid = las_grid(kind, plan["smem"])["blocks"]
        split(f"K9 {kind[3:]} grid={grid}", fn, plan, args.reps, "las_fused_stamps", 4, n)
        timeline(f"K9 {kind[3:]}", fn, plan, n // 2, 5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="decode,las",
                    help="decode (K5, K4), las (K2, K9), head (K7)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_phase_split: needs a CUDA device", file=sys.stderr)
        return 2
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import _dec_embedder, init_seq2seq
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops.masks import position_signal

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.NVCC_FLAGS = [*kernels.NVCC_FLAGS, "-DSTJEP_FUSED_STAMPS"]
    kernels.lib()
    cfg = ModelConfig(**cs.FLAGSHIP)
    params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu"),
                       "cuda")
    rng = np.random.RandomState(args.seed)
    K, BK, i = cs.BEAM, cs.B * cs.BEAM, cs.DECODE_LEN // 2
    table = _dec_embedder(params, cfg).contiguous()
    tsig = position_signal(500, cfg.dim_model, "cuda")[0].contiguous()
    if "las" in args.only:
        split_las(args, params, cfg, rng)
    if "head" in args.only:
        split_head(args, params, cfg, rng)
    variants = ((False, False, 0), (False, False, 132), (True, True, 0))
    for quant, bf16, grid_blocks in variants if "decode" in args.only else ():
        df.FUSED_GRID = grid_blocks
        st = cs.decode_state(params, cfg, rng, i - 1, bf16=bf16)
        c = st["cache"]
        dec = cs.serving_decoder(params, quant)
        x = torch.from_numpy(rng.randn(BK, cfg.dim_model).astype(np.float32)).cuda()
        lp = dec["layers"][0]
        label = cs.variant_label(quant, bf16)
        Lpad, Lk = c.self_k.shape[3], c.mem_k.shape[2]
        plan5 = df.fused_plan(BK, cfg.dim_model, cfg.dim_feedforward, cfg.num_heads, Lpad, Lk,
                              quant, K=K)
        grid = grid_blocks or df.fused_grid(quant, bf16, False, plan5["smem"])["blocks"]
        label = f"{label} grid={grid}"
        split(f"K5 {label}", lambda: df.decoder_layer_step_flash(
            lp, x, c.self_k[0], c.self_v[0], c.mem_k[0], c.mem_v[0], i - 1, cfg.num_heads,
            st["anc"], K, st["mem_mask"], st["maskk"]), plan5, args.reps)
        plan4 = df.fused_plan(BK, cfg.dim_model, cfg.dim_feedforward, cfg.num_heads, Lpad, Lk,
                              quant, True, cfg.dec_layers, cfg.dec_vocab_size, K)
        eos = torch.zeros(BK, dtype=torch.int32, device="cuda")
        scores = torch.zeros(BK, device="cuda")
        lenm = torch.ones(BK, device="cuda")
        stacked = df.stack_decoder_layers(dec)
        last_tok = st["preds"][:, i - 1].contiguous()
        split(f"K4 {label}", lambda: df.decode_beam_step_flash(
            stacked, dec["norm"], params["out_tgt"], table, tsig, i, last_tok, st["preds"],
            st["anc"], st["maskk"], st["mem_mask"], scores, eos, lenm, c.self_k, c.self_v,
            c.mem_k, c.mem_v, cfg.num_heads, K, 1.0), plan4, args.reps)
    df.FUSED_GRID = 0
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
