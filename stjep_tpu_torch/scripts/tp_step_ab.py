#!/usr/bin/env python3
"""The tensor-parallel step kernels and the TP beam of one checkout, timed for A/B runs on one GPU.

    python3 stjep_tpu_torch/scripts/tp_step_ab.py [--root DIR] [--label LABEL] \\
        [--seed 0] [--layers]

Imports chip_smoke.py and stjep_tpu_torch from --root (this checkout by
default; for a parent commit, a checkout of it unpacked from `git archive`),
builds that checkout's kernel library and runs at chip_smoke.py's
flagship, f32 weights, random from the seed:
- its phase_tp_kernels: K6a-c and K7c at one shard of 4 (BK = 80, pos 75),
  each against its plain version, with CUDA-event times and bounds;
- its phase_k5 and phase_k4 in f32 (K5 and K4 share decode_fused.cu's code
  with the fused K6a-c), and K5 and K4 alone back to back as below: the
  stream's microseconds a call are their device time, since either kernel
  takes longer than the host needs to issue it (no torch.profiler here: a
  profile of thousands of events has left later profiles in the process
  empty);
- K6a-c (the wrappers as that checkout has them) back to back, 200
  calls at the same shard of 4: the host's microseconds to issue a call
  (host clock, no synchronise inside) and the stream's microseconds a call
  (CUDA events around the 200): the larger of the two sets a TP position's
  pace; where the checkout has the fused steps, also their C entry alone
  (`kernels.launch` with the wrapper's arguments built once), whose host
  us is what the wrapper's Python adds to;
- ST beam-5 through forward_translate at B=16 on meshes (1, 2) and (1, 4)
  of the card, and (1, 2) with bf16 caches: one warm-up and 2 timed
  requests each, utt/s on the host clock (no token check: chip_smoke.py
  holds the tokens).
With --layers, only K5, K4 and the fused K6a-c's C entries alone back to
back (their device time, each kernel outlasting its issue).
Prints the phases' own lines, then one JSON line `ab {...}` with the label,
the nvidia-smi line and the numbers. To compare two trees, run them in one
call on one card in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def back_to_back(fn, n=200):
    """(host us to issue a call, stream us a call) over n calls of fn in a
    row after a warm-up."""
    import time

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return round(host * 1e6 / n, 2), round(a.elapsed_time(b) * 1e3 / n, 2)


def step_calls(cs, params, cfg, rng):
    """K6a, K6b (residual off) and K6c (partial_tp) at one shard of TP_N,
    as the TP beam calls them, and where the checkout has the fused steps,
    each one's C entry alone with the same arguments."""
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.ops import decode_flash as df

    n, K, pos = cs.TP_N, cs.BEAM, cs.DECODE_LEN // 2
    Dq, nh = cfg.dim_model // n, cfg.num_heads // n
    s0 = cs.tp_shards(params, n)[0]["dec_tgt"]["layers"][0]
    st = cs.decode_state(params, cfg, rng, pos)
    c, anc, maskk, mm = st["cache"], st["anc"], st["maskk"], st["mem_mask"]
    ck, cv, mk, mv = (t[0][..., :Dq].contiguous() for t in c)
    x = torch_randn(rng, cs.B * K, cfg.dim_model)
    calls = {"K6a": lambda: df.self_attn_step(s0["decslf_attn"], x, ck, cv, pos, nh, anc, K,
                                              maskk, False),
             "K6b": lambda: df.cross_attn_step(s0["encdec_attn"], x, mk, mv, nh, K, mm, False),
             "K6c": lambda: df.ffn_step(s0["pos_ffn"], x, True)}
    if "ffn_step_fused" not in kernels._SIGS:
        return calls
    BK, D = x.shape
    y = torch.empty_like(x)
    sa, ca, ff = s0["decslf_attn"], s0["encdec_attn"], s0["pos_ffn"]
    Lpad, Lk, FF = ck.shape[2], mk.shape[1], ff["w_1"]["w"].shape[1]
    ps = df.fused_plan(BK, D, 0, nh, Lpad, 0, K=K, Dq=Dq, step="self",
                       smem_max=df.step_smem_max("self", False))
    pc = df.fused_plan(BK, D, 0, nh, 0, Lk, K=K, Dq=Dq, step="cross",
                       smem_max=df.step_smem_max("cross", False))
    pf = df.fused_plan(BK, D, FF, 1, 0, 0, step="ffn")
    ws = lambda plan: torch.empty((plan["ws_floats"],), device="cuda")
    tiles = lambda step, ff_w=0, dq=Dq: df._tiles_on(x.device, BK, D, ff_w, 0, dq, step)
    entry = lambda name, *args: lambda: kernels.launch(name, *args)
    calls["K6a entry"] = entry(
        "self_attn_step_fused", sa["layer_norm"]["scale"], sa["layer_norm"]["bias"],
        sa["w_qs"]["w"], sa["w_ks"]["w"], sa["w_vs"]["w"], sa["fc"]["w"], x, y, ck, cv, anc,
        maskk, ws(ps), tiles("self"), 0, 0, ps["ws_floats"], pos, BK, K, Lpad, D, Dq, nh,
        ps["smem"], ps["blocks"])
    calls["K6b entry"] = entry(
        "cross_attn_step_fused", ca["layer_norm"]["scale"], ca["layer_norm"]["bias"],
        ca["w_qs"]["w"], ca["fc"]["w"], x, y, mk, mv, mm, ws(pc), tiles("cross"), 0, 0,
        pc["ws_floats"], BK, K, Lk, D, Dq, nh, pc["smem"], pc["blocks"])
    calls["K6c entry"] = entry(
        "ffn_step_fused", ff["layer_norm"]["scale"], ff["layer_norm"]["bias"], ff["w_1"]["w"],
        ff["w_1"]["b"], ff["w_2"]["w"], ff["w_2"]["b"], x, y, ws(pf), tiles("ffn", FF, None), 1,
        pf["ws_floats"], BK, D, FF, pf["smem"], pf["blocks"])
    return calls


def layer_calls(cs, params, cfg, rng):
    """K5 (layer 0) and K4 (every layer, the head and the select) at
    chip_smoke.py's flagship, position 75, f32, as phase_k5 and phase_k4
    call them."""
    from stjep_tpu_torch.models.seq2seq import _dec_embedder
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops.masks import position_signal

    K, BK, i, nh = cs.BEAM, cs.B * cs.BEAM, cs.DECODE_LEN // 2, cfg.num_heads
    st = cs.decode_state(params, cfg, rng, i - 1)
    c, dec = st["cache"], params["dec_tgt"]
    x = torch_randn(rng, BK, cfg.dim_model)
    stacked = df.stack_decoder_layers(dec)
    table = _dec_embedder(params, cfg).contiguous()
    tsig = position_signal(500, cfg.dim_model, "cuda")[0].contiguous()
    eos = torch.zeros(BK, dtype=torch.int32, device="cuda")
    scores, lenm = torch.zeros(BK, device="cuda"), torch.ones(BK, device="cuda")
    last_tok = st["preds"][:, i - 1].contiguous()
    return {"K5": lambda: df.decoder_layer_step_flash(
                dec["layers"][0], x, c.self_k[0], c.self_v[0], c.mem_k[0], c.mem_v[0], i - 1, nh,
                st["anc"], K, st["mem_mask"], st["maskk"]),
            "K4": lambda: df.decode_beam_step_flash(
                stacked, dec["norm"], params["out_tgt"], table, tsig, i, last_tok, st["preds"],
                st["anc"], st["maskk"], st["mem_mask"], scores, eos, lenm, c.self_k, c.self_v,
                c.mem_k, c.mem_v, nh, K, 1.0)}


def torch_randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype("float32")).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np

    if not torch.cuda.is_available():
        print("tp_step_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = ModelConfig(**cs.FLAGSHIP)
    params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu"), "cuda")
    rng = np.random.RandomState(args.seed)
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err")
    out = {"label": args.label, "root": args.root, "nvidia_smi": smi}
    if args.layers:
        calls = {**layer_calls(cs, params, cfg, rng),
                 **{k: f for k, f in step_calls(cs, params, cfg, rng).items() if "entry" in k}}
        for name, fn in calls.items():
            out[name] = {"host_us, stream_us": back_to_back(fn)}
        print("ab " + json.dumps(out), flush=True)
        return 0
    for name, r in cs.phase_tp_kernels(params, cfg, rng).items():
        out[name] = {k: r[k] for k in keys}
    out["K5"] = {k: cs.phase_k5(params, cfg, rng)[k] for k in keys}
    out["K4"] = {k: cs.phase_k4(params, cfg, rng)[k] for k in keys}
    for name, fn in layer_calls(cs, params, cfg, rng).items():
        out[name]["host_us, stream_us"] = back_to_back(fn)
    for name, fn in step_calls(cs, params, cfg, rng).items():
        out[f"{name} host_us, stream_us"] = back_to_back(fn)
    reqs = [cs.inputs(rng, cs.B) for _ in range(2)]
    ran = cs.LAS_RAN + ("K4 select", "K6 ffn_step", "K7 head_partial")
    for n, opts in ((2, {}), (cs.TP_N, {}), (2, cs.BF16_OPTS)):
        cs.tp_mesh(n)
        try:
            _, secs, _ = cs.translate_timed(params, cfg, reqs[:1] + reqs, ran, **opts)
        finally:
            cs.tp_mesh(0)
        out[f"tp beam n={n}" + (" bf16" if opts else "")] = round(2 * cs.B / sum(secs[1:]), 3)
    print("ab " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
