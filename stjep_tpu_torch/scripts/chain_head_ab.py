#!/usr/bin/env python3
"""K3 and K7c of one checkout, and the decode paths that run them, timed for A/B runs on one GPU.

    python3 stjep_tpu_torch/scripts/chain_head_ab.py [--root DIR] [--label LABEL] [--seed 0]

Imports chip_smoke.py and stjep_tpu_torch from --root (this checkout by
default; for a parent commit, a checkout of it unpacked from `git
archive`), builds that checkout's kernel library and measures at
chip_smoke.py's flagship, f32 weights random from the seed:
- K3 (decode_chain_step_flash) at BK = 80, position 0, with f32 weights
  and caches and with int8 weights and bf16 caches; K3's gather variant at
  BK = 16, position 75 (greedy dev eval's shapes, top-1); K7c
  (decode_head_partial) at BK = 80 on a vocabulary shard of 4 (V/n = 50),
  without and with gather ids. For each: the median ms of one call between
  CUDA events (host included, chip_smoke.py's cuda_ms), the device
  operations of one call and their summed device us (torch.profiler, an
  empty profile taken again: chip_smoke.py's device_ops), and 200 calls
  back to back: the host's us to issue a call and the stream's us a call;
- K5 and K4 at position 75 back to back (scripts/tp_step_ab.py
  layer_calls): their stream us a call is their device time, since either
  kernel outlasts its issue;
- end to end on the host clock, one warm-up call first: greedy dev eval
  (forward_eval ASR_ST with reference ids, B=16, 3 calls) on the standard
  and on the universal model; the ST beam-5 at B=16 (2 requests) on the
  standard model with f32 caches and in serving (int8 weights + bf16
  caches), and serving at B=1 (3 requests, median ms); the TP beam (2
  requests) and TP dev eval (3 calls) on meshes (1, 2) and (1, 4) of the
  card, each with its rows whose tokens equal the single-device card
  route's on the same inputs.
Prints one JSON line `ab {...}` with the label, the nvidia-smi line and the
numbers. To compare two trees, run them in one call on one card in turns:
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def _sibling(name: str):
    """A script beside this one (of this checkout, whatever --root is)."""
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_calls(cs, params, cfg, rng):
    """{label: fn} of K3 (f32, int8+bf16, gather) and K7c (with and
    without gather ids) at chip_smoke.py's shapes, as its phases call
    them."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.models.seq2seq import _embed_tgt_token
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops.masks import position_signal

    K, BK, D = cs.BEAM, cs.B * cs.BEAM, cfg.dim_model
    out_w, norm = params["out_tgt"], params["dec_tgt"]["norm"]

    def chain(st, dec, x, pos, group, topk, gid=None):
        c, stacked = st["cache"], df.stack_decoder_layers(dec)
        return lambda: df.decode_chain_step_flash(
            stacked, dec["norm"], out_w, x, c.self_k, c.self_v, c.mem_k, c.mem_v, pos,
            cfg.num_heads, st["anc"], group, st["mem_mask"], st["maskk"], topk, gather_ids=gid)

    tok = torch.full((BK,), BOS, device="cuda", dtype=torch.int32)
    x0 = _embed_tgt_token(params, cfg, tok) + position_signal(500, D, "cuda")[0, 0]
    calls = {}
    for label, quant in (("K3 f32", False), ("K3 int8+bf16", True)):
        st = cs.decode_state(params, cfg, rng, 0, bf16=quant)
        calls[label] = chain(st, cs.serving_decoder(params, quant), x0, 0, K, K)
    pos = cs.DECODE_LEN // 2
    st = cs.decode_state(params, cfg, rng, pos, K=1)
    x = torch.from_numpy(rng.randn(cs.B, D).astype(np.float32)).cuda()
    gid = torch.from_numpy(rng.randint(0, cfg.dec_vocab_size, cs.B).astype(np.int32)).cuda()
    calls["K3 gather"] = chain(st, params["dec_tgt"], x, pos, 1, 1, gid)
    out0 = cs.tp_shards(params, cs.TP_N)[0]["out_tgt"]
    v = out0["w"].shape[1]
    xh = torch.from_numpy(rng.randn(BK, D).astype(np.float32)).cuda()
    gh = torch.from_numpy(rng.randint(-v, 2 * v, BK).astype(np.int32)).cuda()
    calls["K7c"] = lambda: df.decode_head_partial(norm, out0, xh, K)
    calls["K7c gather"] = lambda: df.decode_head_partial(norm, out0, xh, K, gh)
    return calls


def timed(fn, n):
    """fn's output and its host seconds per call over n calls after one
    warm-up call, each ending in a synchronise."""
    fn()
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def end_to_end(cs, cfg, seed, rng):
    """Dev eval (standard, universal), the ST beam (f32, serving), serving
    B=1, and the TP beam and TP dev eval at n = 2 and 4 with their rows
    equal to the single-device card route's."""
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import BOS, ModelConfig
    from stjep_tpu_torch.infer.forward import forward_eval, forward_translate
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    B = cs.B
    feats, lens = cs.inputs(rng, B)
    f, l = feats.cuda(), lens.cuda()
    res = {}
    for kind in ("standard", "universal"):
        kcfg = ModelConfig(**{**cs.FLAGSHIP, "transformer_type": kind})
        params = params_to(init_seq2seq(kcfg, torch.Generator().manual_seed(seed), "cpu"),
                           "cuda")
        refs = {"ref_src": rng.randint(5, kcfg.enc_vocab_size, (B, kcfg.max_seq_len_src)),
                "ref_tgt": rng.randint(5, kcfg.dec_vocab_size, (B, kcfg.max_seq_len_tgt))}
        refs = {k: torch.from_numpy(r).cuda() for k, r in refs.items()}
        for r in refs.values():
            r[:, 0] = BOS
        dev_eval = lambda: forward_eval(params, kcfg, "ASR_ST", acous_feats=f, acous_lens=l,
                                        device="cuda", **refs)
        single, secs = timed(dev_eval, 3)
        res[f"dev eval {kind} utt/s"] = round(3 * B / sum(secs), 3)
        if kind == "universal":
            break
        beam = lambda fb=f, lb=l, **opts: forward_translate(
            params, kcfg, "ST", acous_feats=fb, acous_lens=lb, beam_width=cs.BEAM,
            penalty_factor=1.0, max_seq_len=cs.DECODE_LEN, device="cuda", **opts)
        tokens, secs = timed(beam, 2)
        res["st beam utt/s"] = round(2 * B / sum(secs), 3)
        _, secs = timed(lambda: beam(**cs.SERVE_OPTS), 2)
        res["serving int8+bf16 B=16 utt/s"] = round(2 * B / sum(secs), 3)
        _, secs = timed(lambda: beam(f[:1], l[:1], **cs.SERVE_OPTS), 3)
        res["serving int8+bf16 B=1 ms"] = round(statistics.median(secs) * 1e3, 3)
        for n in (2, cs.TP_N):
            cs.tp_mesh(n)
            try:
                tp_tokens, secs = timed(beam, 2)
                res[f"tp beam n={n} utt/s"] = round(2 * B / sum(secs), 3)
                tp_eval, secs = timed(dev_eval, 3)
                res[f"tp dev eval n={n} utt/s"] = round(3 * B / sum(secs), 3)
            finally:
                cs.tp_mesh(0)
            res[f"tp beam n={n} rows equal"] = int((tp_tokens == tokens).all(1).sum())
            res[f"tp dev eval n={n} rows equal"] = int(
                (tp_eval["preds_st"] == single["preds_st"]).all(1).sum())
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(HERE.parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_head_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    tp_ab = _sibling("tp_step_ab")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = ModelConfig(**cs.FLAGSHIP)
    params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu"), "cuda")
    rng = np.random.RandomState(args.seed)
    out = {"label": args.label, "root": args.root, "nvidia_smi": smi}
    for name, fn in kernel_calls(cs, params, cfg, rng).items():
        ms = cs.cuda_ms(fn, 20)  # warms fn up for the profile
        n_ops, names, us = cs.device_ops(fn, with_us=True)
        out[name] = {"ms": round(ms, 4), "device_ops": n_ops, "device_us": round(us, 2),
                     "kernels": names, "host_us, stream_us": tp_ab.back_to_back(fn)}
    for name, fn in tp_ab.layer_calls(cs, params, cfg, rng).items():
        out[name] = {"host_us, stream_us": tp_ab.back_to_back(fn)}
    out.update(end_to_end(cs, cfg, args.seed, rng))
    print("ab " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
