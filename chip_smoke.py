#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (stjep_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card and nvcc; builds the kernels from stjep_tpu_torch/csrc
itself. Phases, each printed on its own line; any failure prints its
traceback on stderr and one line `[failed] phase=<phase> error=<error>` on
stdout, and exits 1 without printing a result (no card, or run without the
package beside it, included):

1. device: the card's name and power limit (nvidia-smi), TF32 off.
2. build: compile the CUDA kernels (one nvcc per source, in parallel), with
   the seconds it took.
3. kernels K1-K5, K4's select alone, K3's gather variant and K7 at the
   flagship shapes on seeded inputs: each kernel against its plain PyTorch version on the
   card (floats within a stated tolerance; integer outputs equal wherever
   the plain version's gap to the next rank exceeds 1e-5), with median
   times from CUDA events; K1 (the cluster sweep, its shape and block count
   on the line) also at B=1 and B=64, each with the sweep alone timed
   beside the whole call (input GEMMs included); K7 also at a 30 000-word
   target vocabulary. K2, K3, K4, K5 and K7 are one cooperative launch each
   (csrc/las_fused.cu, csrc/decode_chain.cu, csrc/decode_fused.cu): their
   lines give the grid (blocks, blocks per SM), the grid barriers a launch
   and the shared memory a block; K2's, K3's and K7's also their device
   operations a call (one, K3's and K7's with their device time, K7's with
   the host's us to issue a call) and K2's the floor of streaming its head
   every step (head_stream_floor_ms); K5's the time of the trio (K5 as
   K6a-c in turn) as trio_ms. The serving kernels likewise: K5 in int8,
   bf16 and int8+bf16, K3 (beside its f32 line) and K4 in int8+bf16; the K4
   and K5 lines on LayerNorms drawn at random. The
   tensor-parallel kernels
   (right after K9) at one shard of 4 (Dq = 128, 2 local heads, BK = 80,
   pos 75, V/n = 50): K6a-c (self_attn_step, cross_attn_step, ffn_step,
   their partials) and K7c (decode_head_partial), and K6a and K6b with bf16
   caches and memory at one shard of 2 (the bf16 TP beam's); K6a-c and K7c
   are one fused launch each (csrc/decode_fused.cu, csrc/decode_chain.cu),
   and their lines give the grid, barriers, shared memory and device
   operations a call (one, with its device time). The trio, which has no
   kernel of its own, is checked on its own line: at shard width against
   its plain version, at full width against K5, and the TP layer step over
   4 shards of the card, joined, against K5. Each
   kernel's bound (bytes over HBM bandwidth or operations over peak, from
   this run's inputs; the TP kernels' from scripts/tp_bounds.py) and,
   where one PyTorch call computes the same function, its time: cuDNN's
   LSTM for K1 and K8.
4. the decode main paths, each driven with every launch count zeroed just
   before it and read just after, at the flagship configuration
   (bench.py's), random weights from init_seq2seq(seed):
   - e2e: forward_translate(mode="ST", beam_width=5) on 3 requests of B=16
     (standard decoder: K1-K4); utt/s, a B=1 latency; then the same call
     on CPU copies (the plain route) for one request, with every row that
     differs explained by a tie: at the first divergence, the plain arm's
     own log-probs (LAS symbols) or kept beam scores (beam hypotheses) of
     the two choices agree within 1e-3;
   - e2e universal: the same on the universal transformer (the general
     beam loop: K1, K2, K5 per hop, K7, K4's select; K3 and K4 must not
     launch);
   - dev eval, standard and universal: forward_eval("ASR_ST") with
     reference ids at B=16 (K1, K2 with refs, then K3's gather variant or
     K5 per hop + K7's gather variant); utt/s, and the card against CPU
     copies: preds equal up to ties as above, picked_* within 1e-4.
   - serving, standard model: bf16 caches at B=16 (3 requests, utt/s),
     B=1 (median of 3) and B=64 (one request); int8 weights + bf16 caches
     at B=1 and B=16; with the decoder snapped onto the int8 grid (lossless
     quantization) the int8 route decodes the f32 route's tokens in 16/16
     rows; the bf16 route against its plain route on CPU copies on the 16
     rows of a request, differing rows explained by a tie within
     SERVE_MARGIN net of the drift of the row's shared prefix, that drift
     at most BF16_DRIFT a position (rows 0 and 1 within SERVE_MARGIN
     whole);
   - serving, universal model at B=16: int8 + bf16 and bf16 (K5 variants;
     K3 and K4 idle), and the int8-grid check;
   - tp beam: ST beam-5 through forward_translate on meshes (1, 2) and
     (1, 4) whose shards all lie on the card, and on (1, 2) with bf16
     caches (one warm-up, 2 timed requests of B=16; K6a-c, K7c and K4's
     select launched, and with bf16 K6a's and K6b's bf16 variants, which
     no other main path launches; K3, K4 and K5 idle), f32 tokens against
     the
     single-device card route's, differing rows explained by a tie within
     E2E_MARGIN; bf16 tokens against the same TP route on CPU copies on
     the 16 rows of a request, ties within SERVE_MARGIN net of the drift
     of the row's shared prefix (at most BF16_DRIFT a position);
     tp dev eval: forward_eval
     ASR_ST at n=2 against the single-device card route, picked_* within
     1e-4.
5. kernels K8 (trainable BiLSTM) and K9 (teacher-forced LAS scan; its
   phase runs right after K2's) at the
   flagship train shapes on seeded inputs and cotangents: forward and
   backward each against its plain version on the card, every saved or
   emitted stream within a stated tolerance relative to its max-abs, with
   median times (K8's forward sweep also alone, and both sweeps' cluster
   shapes; K9's fused launch: grid, barriers, shared memory, and its device
   operations a call under torch.profiler, which must be one).
6. train parity: one deterministic ASR_ST step (no dropout, no
   SpecAugment) at full widths with B=2 and 256 frames, on inputs of its
   own stream: the kernel route on the card, and the plain route on CPU
   copies, both f32, each against the plain route in float64 on the same
   ReLU pieces: the loss, every gradient leaf (within PARITY_TOL of its
   norm), and the parameters after one Adam step (each arm's step against
   Adam's formula from its own gradients).
7. train end to end: make_train_step ASR_ST at the flagship (B=16, 1504
   frames, dropout 0.2, SpecAugment), 2 warm-up and 5 timed steps; steps/s,
   step ms, the losses (finite), peak device memory, K8/K9 launch counts
   on that run, and every trained parameter moved by a step.

The last lines: a JSON object with one entry per kernel (its launches
summed over the main paths' runs), the total seconds, the nvidia-smi line,
then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

TIE = 1e-5  # integer outputs may differ only where the plain top-2 gap is below this
E2E_MARGIN = 1e-3  # first-divergence margin that explains a differing e2e row
# bf16 caches, card against the plain route: both round at the same points,
# but the f32 values they round come from GEMMs summed in other orders, so
# a value near a bf16 rounding boundary lands one bf16 step (2^-8
# relative) apart. That moves a hidden state or log-prob by up to ~1e-3,
# so two beam candidates closer than SERVE_MARGIN may swap: a tie at that
# margin explains a differing row
SERVE_MARGIN = 1e-2
# and over a shared prefix they drift apart by up to ~3e-3 a position
# (stjep_tpu_torch/scripts/bf16_drift.py): a row held net of its prefix
# drift may drift at most this much a position up to where it parts
BF16_DRIFT = 3e-3
# the least time the card could take (H100 SXM datasheet peaks at 700 W): bytes over HBM bandwidth, operations over the peak of
# their type; these kernels use no tensor cores, so f32 operations count
# against the CUDA cores' 67 TFLOP/s and bf16 products against 989
HBM_BYTES_PER_S = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12}

# bench.py's flagship workload (bench.py:24-38,120-129)
FLAGSHIP = dict(
    enc_vocab_size=30000, dec_vocab_size=200, enc_embedding_size=200,
    dec_embedding_size=512, acous_dim=40, acous_hidden_size=256,
    dim_model=512, dim_feedforward=1024, num_heads=8, enc_layers=6,
    dec_layers=6, num_unilstm_dec=3, spec_aug=True, dropout=0.2,
    max_seq_len_src=90, max_seq_len_tgt=150, mode="ASR_ST")
B, FRAMES, DECODE_LEN, BEAM = 16, 1504, 150, 5
TRAIN_LR = 1e-4  # bench.py's train row
PARITY_B, PARITY_FRAMES = 2, 256
# train parity: each gradient leaf's distance from float64 on the same ReLU
# pieces, relative to its norm. Both f32 arms read 1.2e-5 to 2.1e-5 over
# seeds 0-7 (stjep_tpu_torch/scripts/train_parity_seeds.py on an H100)
PARITY_TOL = 1e-4


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def need(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the card, each call timed with CUDA
    events after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def cache_err(a, b, bf16) -> float:
    """Cache rows [nl, ...] (or one layer's), kernel a against plain b: max
    abs error (f32). For bf16, layer 0 (whose inputs the two share) in bf16
    steps: its largest difference over 2^-7 of the value plus 1e-4 for f32
    rows that differ near zero by summation order, at most 1 when the two
    rounded the same value or its neighbour; the deeper layers' rows carry
    the earlier layers' differences (SERVE_TOL's), so they are held to
    DEEP_CACHE_REL of the cache's largest magnitude."""
    if not bf16:
        return max_err(a, b)
    a, b = a.double(), b.double()
    if a.dim() == 5 and a.shape[0] > 1:
        deep = max_err(a[1:], b[1:]) / float(b[1:].abs().max())
        need(deep <= DEEP_CACHE_REL, f"bf16 cache rows past layer 0 differ by {deep} of "
             f"their scale > {DEEP_CACHE_REL}")
        a, b = a[0], b[0]
    return float(((a - b).abs() / (2.0 ** -7 * b.abs() + 1e-4)).max())


DEEP_CACHE_REL = 2e-2  # a few bf16 steps (2^-7 = 7.8e-3) of the rows' scale


def nbytes(*xs) -> int:
    """Bytes of every tensor in xs (nested in tuples, lists and dicts)."""
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total


def bound(n_bytes, flops, peak="f32", bf16_flops=0):
    """bound_ms, the larger of bytes over HBM bandwidth and operations
    over the peak of their type (flops at `peak`'s, bf16_flops at bf16's),
    and which of the two sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, flops / PEAK[peak] + bf16_flops / PEAK["bf16"]
    return dict(bound_ms=max(t_b, t_o) * 1e3, bound_by="bytes" if t_b >= t_o else "operations")


def layer_weight_bytes(cfg, quant) -> int:
    """One decoder layer's streamed bytes: 6 D x D and 2 D x FF matrices
    (f32, or int8 with f32 scales per column), LayerNorms and FFN biases."""
    D, FF = cfg.dim_model, cfg.dim_feedforward
    cols, small = 7 * D + FF, 4 * (6 * D + FF + D)
    mats = 6 * D * D + 2 * D * FF
    return (mats + 4 * cols if quant else 4 * mats) + small


def distinct_rows(anc, K, pos) -> int:
    """The distinct self-cache rows below pos that the ancestry anc [Lpad,
    BK] reads (slot anc[l, r] of batch entry r // K at position l)."""
    BK = anc.shape[1]
    Bn = BK // K
    b = torch.arange(BK) // K
    keys = anc[:pos].long().cpu() * Bn + b + torch.arange(pos)[:, None] * K * Bn
    return keys.unique().numel()


def decode_bound(cfg, nl, K, pos, anc, mem_mask, cache_itemsize, quant, V=0, topk=0):
    """Bytes and operations that nl decode layers at `pos` must spend (K5;
    with V, the head after them: K3), counted from this call's data: the
    distinct self-cache rows the ancestry reads below pos, the new rows
    written, the valid memory rows, the weights once; the layers' products,
    both attentions, and the head's product."""
    D, FF = cfg.dim_model, cfg.dim_feedforward
    BK = anc.shape[1]
    rows, mem_rows = distinct_rows(anc, K, pos), int(mem_mask.sum())
    per_layer = (layer_weight_bytes(cfg, quant)
                 + (2 * rows + 2 * BK + 2 * mem_rows) * D * cache_itemsize)
    n_bytes = nl * per_layer + 4 * BK * D + 8 * (pos + 1) * BK + 4 * mem_mask.numel()
    flops = nl * (2 * BK * (6 * D * D + 2 * D * FF) + 4 * BK * (pos + 1) * D
                  + 4 * K * mem_rows * D)
    if V:
        n_bytes += 4 * (2 * D + D * V) + 8 * BK * topk
        flops += 2 * BK * D * V
    return n_bytes, flops


def lstm_flops(lens, din, H) -> int:
    """Both directions' input and recurrent products over the valid frames."""
    return 2 * int(lens.sum()) * (2 * din * 4 * H + 2 * H * 4 * H)


def cudnn_bilstm(p, din, H, train=False):
    """torch.nn.LSTM (cuDNN, bidirectional) holding a K1/K8 layer's weights:
    the library yardstick, timed beside the kernels and used nowhere else."""
    m = torch.nn.LSTM(din, H, batch_first=True, bidirectional=True).cuda()
    with torch.no_grad():
        for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
            getattr(m, "weight_ih_l0" + sfx).copy_(p[d]["w_ih"].t())
            getattr(m, "weight_hh_l0" + sfx).copy_(p[d]["w_hh"].t())
            getattr(m, "bias_ih_l0" + sfx).copy_(p[d]["b_ih"])
            getattr(m, "bias_hh_l0" + sfx).copy_(p[d]["b_hh"])
    m.requires_grad_(train)
    return m


def packed(x, lens):
    return torch.nn.utils.rnn.pack_padded_sequence(x, lens.cpu(), batch_first=True,
                                                   enforce_sorted=False)


def inputs(rng, n):
    """Seeded fbank-shaped features and lengths, as bench.py makes them."""
    feats = rng.randn(n, FRAMES, 40).astype(np.float32)
    lens = rng.randint(FRAMES // 2, FRAMES - 8, size=(n,)).astype(np.int64)
    lens[0] = FRAMES - 8  # round_up8(max) == FRAMES
    return torch.from_numpy(feats), torch.from_numpy(lens)


def first_diff(a, b):
    """Per row: the first column where a and b differ, or None."""
    d = (a.cpu() != b.cpu())
    return [int(np.argmax(r)) if r.any() else None for r in d.numpy()]


def sweep_call(p, x, lens, save=False):
    """K1's (or, with save, K8's forward) recurrent sweep alone, on input
    projections made once: a closure that launches only the cluster kernel."""
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.ops.lstm_pallas import input_projections, sweep_shape

    B, T, _ = x.shape
    H = p["fwd"]["w_hh"].shape[0]
    xp = input_projections(x, (p["fwd"]["w_ih"], p["bwd"]["w_ih"]),
                           tuple(q["b_ih"] + q["b_hh"] for q in (p["fwd"], p["bwd"])))
    whh = [q["w_hh"].contiguous() for q in (p["fwd"], p["bwd"])]
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((B, T, 2 * H), device=x.device)
    if save:
        saves = [torch.empty((2, T, B, n), device=x.device) for n in (H, H, 4 * H)]
        return lambda: kernels.launch("bilstm_fwd_save", *xp, *whh, lens, out, *saves,
                                      B, T, H, *sweep_shape(B, H))
    return lambda: kernels.launch("bilstm_recurrent", *xp, *whh, lens, out, B, T, H,
                                  *sweep_shape(B, H))


def plan_text(B, H, backward=False) -> str:
    """The cluster sweep's launch at (B, H): BTxC, blocks, threads, shared
    memory, where W_hh's slice lives, clusters the card holds at once."""
    from stjep_tpu_torch.ops.lstm_pallas import sweep_plan

    q = sweep_plan(B, H, backward)
    return (f"BT{q['bt']}xC{q['c']}:{q['blocks']}blocks:{q['threads']}thr:"
            f"{q['smem']}B:W_hh_{q['w_hh']}:max{q['max_clusters']}clusters")


def phase_k1(params, cfg, rng):
    """K1 over the four pyramid layers at B=16 (the kernels line's row),
    and at B=1 and B=64 beside it: the whole call (input GEMMs and sweep),
    the sweep alone, the plain version (B=16) and cuDNN's LSTM."""
    from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas, bilstm_plain

    enc = params["las"]["encoder"]
    H = cfg.acous_hidden_size
    # outputs are LSTM states in (-1, 1); f32 on both sides, summed in another
    # order (GEMM tiles vs ATen) over up to 1504 contractive recurrent steps
    tol = 1e-4
    res = {}
    for Bn in (B, 1, 64):
        lens = torch.from_numpy(rng.randint(FRAMES // 2, FRAMES, size=(Bn,))).cuda()
        T, din = FRAMES, cfg.acous_dim
        err, lib_err, n_bytes, flops, shapes, steps = 0.0, 0.0, 0, 0, [], 0
        ms = {k: 0.0 for k in ("ms", "sweep_ms", "plain_ms", "library_ms")}
        for li in range(cfg.num_pyramid_layers):
            shapes.append(f"({T},{din})")
            steps += T
            p = enc[f"acous_enc_l{li + 1}"]
            x = torch.from_numpy(rng.uniform(-1, 1, (Bn, T, din)).astype(np.float32)).cuda()
            args = (p["fwd"], p["bwd"], x, lens)
            out = bilstm_pallas(*args)
            err = max(err, max_err(out, bilstm_plain(*args)))
            ms["ms"] += cuda_ms(lambda: bilstm_pallas(*args), 5)
            ms["sweep_ms"] += cuda_ms(sweep_call(p, x, lens), 5)
            if Bn == B:
                ms["plain_ms"] += cuda_ms(lambda: bilstm_plain(*args), 2)
            n_bytes += nbytes(p, x, lens, out)
            flops += lstm_flops(lens, din, H)
            lstm, xp = cudnn_bilstm(p, din, H), packed(x, lens)
            with torch.no_grad():
                lib = torch.nn.utils.rnn.pad_packed_sequence(lstm(xp)[0], batch_first=True,
                                                             total_length=T)[0]
                lib_err = max(lib_err, max_err(lib, out))
                ms["library_ms"] += cuda_ms(lambda: lstm(xp), 5)
            T, din, lens = T // 2, 4 * H, lens // 2
        b = bound(n_bytes, flops)
        res[Bn] = dict(max_abs_err=err, **ms, **b)
        say(f"kernel K1 bilstm B={Bn}", T_Din=",".join(shapes), max_abs_err=err, tol=tol,
            **{k: v for k, v in ms.items() if Bn == B or k != "plain_ms"},
            sweep_steps=steps,
            cluster=plan_text(Bn, H), library_max_abs_err=lib_err, **b)
        need(err <= tol, f"K1 B={Bn} max_abs_err {err} > {tol}")
    return {k: v for k, v in res[B].items() if k != "sweep_ms"}


def phase_k2(params, cfg, rng):
    from stjep_tpu_torch.bridge import leaves
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.ops.attention import precompute_keys
    from stjep_tpu_torch.ops.las_flash import las_greedy_flash, las_greedy_plain, las_plan

    dec = params["las"]["decoder"]
    Tk, n = FRAMES // 8, cfg.max_seq_len_src - 1
    acous = torch.from_numpy(rng.uniform(-1, 1, (B, Tk, 2 * cfg.acous_hidden_size))
                             .astype(np.float32)).cuda()
    wk = precompute_keys(dec["acous_att"], acous, "bilinear")["wk"]
    lens_k = torch.from_numpy(rng.randint(Tk // 2, Tk + 1, size=(B,))).cuda()
    sym0 = torch.full((B,), BOS, device="cuda")
    args = (dec, cfg, wk, acous, lens_k, sym0, n)
    embs_k, preds_k, picked_k = las_greedy_flash(*args)
    embs_p, preds_p, picked_p = las_greedy_plain(*args)
    at_k = las_greedy_plain(*args, ref_tokens=preds_k)[2]  # plain logp of the kernel's pick
    at_p = las_greedy_plain(*args, ref_tokens=preds_p)[2]  # plain logp of its own pick
    err, rows = 0.0, 0
    for r, c in enumerate(first_diff(preds_k, preds_p)):
        end = n if c is None else c + 1  # step c's embedding precedes its pick
        err = max(err, max_err(embs_k[r, :end], embs_p[r, :end]),
                  max_err(picked_k[r, :end], picked_p[r, :end]))
        if c is not None:
            rows += 1
            gap = float(at_p[r, c] - at_k[r, c])
            need(gap <= TIE, f"K2 row {r} step {c}: symbols differ, plain gap {gap}")
    ms = cuda_ms(lambda: las_greedy_flash(*args), 5)
    plain_ms = cuda_ms(lambda: las_greedy_plain(*args), 3)
    n_ops, op_names = device_ops(lambda: las_greedy_flash(*args))
    need(n_ops == 1, f"K2: {n_ops} device operations a call ({op_names}), not one launch")
    plan = las_plan("greedy", B, Tk, wk.shape[2], embs_k.shape[2], acous.shape[2],
                    E=cfg.enc_embedding_size, V=cfg.enc_vocab_size, nl=cfg.num_unilstm_dec,
                    steps=n)
    # dynamic embeddings are unbounded FFN outputs fed back through 89
    # recurrent steps; f32 on both sides, summed in another order
    tol = 1e-3
    # every step reads the step weights (not the keys' projection, applied
    # once outside) and one embedding row per utterance; its products and
    # the attention over the Tk keys and values
    step_w = {k: v for k, v in dec.items() if k not in ("embedder", "acous_att")}
    mats = sum(t.numel() for t in leaves(step_w) if t.dim() == 2)
    n_bytes = (nbytes(step_w, wk, acous, lens_k, embs_k, preds_k, picked_k)
               + n * B * dec["embedder"].shape[1] * 4)
    flops = n * (2 * B * mats + 2 * B * Tk * (wk.shape[2] + acous.shape[2]))
    b = bound(n_bytes, flops)
    # the head's [Hs, V] weights do not fit on chip: each step streams them
    # from device memory, a floor above the bound's read-once count
    head_floor = n * nbytes(dec["acous_out"]["w"]) / HBM_BYTES_PER_S * 1e3
    say("kernel K2 las_greedy", steps=n, V=cfg.enc_vocab_size, max_abs_err=err,
        tol=tol, tied_rows=rows, ms=ms, plain_ms=plain_ms, device_ops_per_call=n_ops,
        device_kernels=",".join(op_names), fused=las_launch("greedy", plan),
        head_stream_floor_ms=head_floor, **b)
    need(err <= tol, f"K2 max_abs_err {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def decode_state(params, cfg, rng, pos, K=BEAM, bf16=False, device="cuda"):
    """A seeded decode state at position `pos` for B=16 and group K (the
    beam's 5 by default): memory K/V of 89 encoder positions (padded to
    96), caches filled below pos (cast to bf16 with bf16), a random ancestry
    with each row's own slot at pos, and random prefix tokens; on `device`
    (params there too)."""
    from stjep_tpu_torch.config import BOS, PAD
    from stjep_tpu_torch.models.tf_decoder import tf_decoder_init_cache_chain
    from stjep_tpu_torch.ops.decode_flash import CROSS_BLOCK, pad_len

    BK, Lk, D = B * K, cfg.max_seq_len_src - 1, cfg.dim_model
    enc = torch.from_numpy(rng.randn(B, Lk, D).astype(np.float32)).to(device)
    cache = tf_decoder_init_cache_chain(params["dec_tgt"], cfg, enc, DECODE_LEN, K)
    Lpad = cache.self_k.shape[3]
    fill = lambda: torch.from_numpy(rng.randn(*cache.self_k[:, :, :, :pos].shape)
                                    .astype(np.float32)).to(device)
    cache.self_k[:, :, :, :pos] = fill()
    cache.self_v[:, :, :, :pos] = fill()
    if bf16:
        cache = type(cache)(*(t.to(torch.bfloat16) for t in cache))
    preds = torch.full((BK, Lpad), PAD, dtype=torch.int32)
    preds[:, 1:pos + 1] = torch.from_numpy(rng.randint(4, cfg.dec_vocab_size, (BK, pos)))
    preds[:, 0] = BOS
    anc = torch.from_numpy(rng.randint(0, K, (Lpad, BK))).int()
    anc[pos] = torch.arange(BK, dtype=torch.int32) % K
    mem_len = rng.randint(1, Lk + 1, size=(B,))
    mem_mask = np.zeros((pad_len(Lk, CROSS_BLOCK), B), np.int32)
    for b, m in enumerate(mem_len):
        mem_mask[:m, b] = 1
    return dict(cache=cache, preds=preds.to(device), anc=anc.to(device),
                maskk=(preds != PAD).T.int().contiguous().to(device),
                mem_mask=torch.from_numpy(mem_mask).to(device))


def clone_cache(c):
    return type(c)(*(t.clone() for t in c))


def serving_decoder(params, quant):
    from stjep_tpu_torch.ops.decode_flash import quantize_decoder_weights

    return quantize_decoder_weights(params["dec_tgt"]) if quant else params["dec_tgt"]


def random_norms(dec, rng):
    """dec with every LayerNorm (each layer's three and the final one) at
    random scales and biases, so that no two are alike: init_seq2seq gives
    them all ones and zeros, under which a kernel reading the wrong one
    still matches its plain version."""
    D = dec["norm"]["scale"].numel()
    ln = lambda: {k: torch.from_numpy((rng.randn(D) * 0.1 + (k == "scale")).astype(np.float32))
                  .cuda() for k in ("scale", "bias")}
    layers = [{k: {**v, "layer_norm": ln()} for k, v in lp.items()} for lp in dec["layers"]]
    return {**dec, "layers": layers, "norm": ln()}


def variant_label(quant, bf16):
    return "+".join(n for n, on in (("int8", quant), ("bf16", bf16)) if on) or "f32"


# serving variants against plain on the card: bf16 caches round where plain
# rounds, from f32 values summed in another order (SERVE_MARGIN's reason):
# hidden states and log-probs of magnitude <= ~10 move by up to a few 1e-3
SERVE_TOL = 5e-3


def fused_launch(cfg, BK, K, cache, quant, bf16, beam=False, chain=False):
    """The fused launch of K5 (or, with beam, K4; with chain, K3) at this
    call's shapes: the grid the card holds (blocks, blocks per SM), the
    grid barriers a launch and the dynamic shared memory a block
    (ops/decode_flash.py fused_plan, fused_grid)."""
    from stjep_tpu_torch.ops.decode_flash import fused_grid, fused_plan

    Lpad, Lk = cache.self_k.shape[3], cache.mem_k.shape[2]
    plan = fused_plan(BK, cfg.dim_model, cfg.dim_feedforward, cfg.num_heads, Lpad, Lk, quant,
                      beam, cfg.dec_layers, cfg.dec_vocab_size, K, chain=chain)
    g = fused_grid(quant, bf16, beam, plan["smem"], chain=chain)
    return dict(grid_blocks=g["blocks"], blocks_per_sm=g["blocks_per_sm"],
                barriers=plan["barriers"], smem_bytes=plan["smem"])


def one_launch(name, fn):
    """The device operations of one call of fn under torch.profiler after
    a warm-up call, which must be one, with that kernel's device
    microseconds."""
    fn()
    n_ops, names, us = device_ops(fn, with_us=True)
    need(n_ops == 1, f"{name}: {n_ops} device operations a call ({names}), not 1")
    return dict(device_ops=n_ops, profiled_kernel_us=us)


def phase_k3(params, cfg, rng, quant=False, bf16=False):
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.models.seq2seq import _embed_tgt_token
    from stjep_tpu_torch.ops.decode_flash import (
        decode_chain_step_flash,
        decode_chain_step_plain,
        stack_decoder_layers,
    )
    from stjep_tpu_torch.ops.masks import position_signal

    K, BK = BEAM, B * BEAM
    st = decode_state(params, cfg, rng, 0, bf16=bf16)  # position 1 reads position 0 only
    tok = torch.full((BK,), BOS, device="cuda", dtype=torch.int32)
    x = _embed_tgt_token(params, cfg, tok) + position_signal(500, cfg.dim_model, "cuda")[0, 0]
    dec = serving_decoder(params, quant)
    stacked = stack_decoder_layers(dec)

    def run(fn, cache, topk):
        return fn(stacked, dec["norm"], params["out_tgt"], x, cache.self_k,
                  cache.self_v, cache.mem_k, cache.mem_v, 0, cfg.num_heads,
                  st["anc"], K, st["mem_mask"], st["maskk"], topk)

    ck, cp = clone_cache(st["cache"]), clone_cache(st["cache"])
    sc_k, ids_k = run(decode_chain_step_flash, ck, K + 1)
    sc_p, ids_p = run(decode_chain_step_plain, cp, K + 1)
    c_err = max(cache_err(ck.self_k, cp.self_k, bf16), cache_err(ck.self_v, cp.self_v, bf16))
    err = max_err(sc_k, sc_p) if bf16 else max(max_err(sc_k, sc_p), c_err)
    # log-probs of magnitude <= ~10 after 6 layers in f32, summed in another
    # order; with bf16 caches six layers of SERVE_TOL's rounding flips
    # (3.7e-3 read on an H100), so twice K5's limit
    tol = 2 * SERVE_TOL if bf16 else 1e-4
    need(not bf16 or c_err <= 1, f"K3 bf16 cache rows {c_err} bf16 steps apart")
    tie = tol if bf16 else TIE
    rows = 0
    for r, c in enumerate(first_diff(ids_k[:, :K], ids_p[:, :K])):
        if c is not None:
            rows += 1
            gap = float((sc_p[r, :K] - sc_p[r, 1:K + 1]).min())
            need(gap <= tie, f"K3 row {r}: ids differ, plain top-k gap {gap}")
    ms = cuda_ms(lambda: run(decode_chain_step_flash, ck, K), 20)
    plain_ms = cuda_ms(lambda: run(decode_chain_step_plain, cp, K), 10)
    b = bound(*decode_bound(cfg, cfg.dec_layers, K, 0, st["anc"], st["mem_mask"],
                            ck.self_k.element_size(), quant, cfg.dec_vocab_size, K))
    label = f"K3 decode_chain_step {variant_label(quant, bf16)}"
    say(f"kernel {label}", BK=BK, pos=0, max_abs_err=err, tol=tol, cache_err=c_err,
        tied_rows=rows, ms=ms, plain_ms=plain_ms, **b,
        **fused_launch(cfg, BK, K, ck, quant, bf16, chain=True),
        **one_launch(label, lambda: run(decode_chain_step_flash, ck, K)))
    need(err <= tol, f"K3 max_abs_err {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def phase_k4(params, cfg, rng, quant=False, bf16=False):
    from stjep_tpu_torch.config import EOS
    from stjep_tpu_torch.models.seq2seq import _dec_embedder, _embed_tgt_token
    from stjep_tpu_torch.ops.decode_flash import (
        beam_candidates,
        decode_beam_step_flash,
        decode_beam_step_plain,
        decode_chain_step_plain,
        stack_decoder_layers,
    )
    from stjep_tpu_torch.ops.masks import position_signal

    K, BK, i = BEAM, B * BEAM, DECODE_LEN // 2  # a mid-decode position
    st = decode_state(params, cfg, rng, i - 1, bf16=bf16)
    eos = torch.from_numpy((rng.rand(BK) < 0.2).astype(np.int32)).cuda()
    scores = torch.from_numpy(-rng.uniform(0, 3 * i, BK).astype(np.float32)).cuda()
    lenm = torch.from_numpy(rng.randint(1, i, BK).astype(np.float32)).cuda()
    last_tok = st["preds"][:, i - 1].contiguous()
    dec = random_norms(serving_decoder(params, quant), rng)
    stacked = stack_decoder_layers(dec)
    table = _dec_embedder(params, cfg).contiguous()
    tsig = position_signal(500, cfg.dim_model, "cuda")[0].contiguous()

    def run(fn, cache, anc):
        return fn(stacked, dec["norm"], params["out_tgt"], table, tsig, i,
                  last_tok, st["preds"], anc, st["maskk"], st["mem_mask"],
                  scores, eos, lenm, cache.self_k, cache.self_v, cache.mem_k,
                  cache.mem_v, cfg.num_heads, K, 1.0)

    ck, cp = clone_cache(st["cache"]), clone_cache(st["cache"])
    anc_k, anc_p = st["anc"].clone(), st["anc"].clone()
    out_k = run(decode_beam_step_flash, ck, anc_k)
    out_p = run(decode_beam_step_plain, cp, anc_p)
    # the plain candidates, to tell ties from faults
    x = _embed_tgt_token(params, cfg, last_tok) + tsig[i - 1]
    sc, _ = decode_chain_step_plain(stacked, dec["norm"], params["out_tgt"], x,
                                    clone_cache(st["cache"]).self_k,
                                    clone_cache(st["cache"]).self_v,
                                    ck.mem_k, ck.mem_v, i - 1, cfg.num_heads,
                                    anc_p, K, st["mem_mask"], st["maskk"], K)
    cand = beam_candidates(sc, scores, eos, lenm, 1.0)[0].sort(dim=1, descending=True)[0]
    gaps = (cand[:, :K] - cand[:, 1:K + 1]).min(dim=1)[0]
    # cumulative scores of magnitude up to ~450 in f32 (rel. 2e-6), plus K3's
    # error; with bf16 caches K3's SERVE_TOL, and ties at that margin
    tol, tie = (2 * SERVE_TOL, SERVE_TOL) if bf16 else (1e-3, TIE)
    names = ("preds", "anc", "maskk", "last_tok", "scores", "eos", "lenm")
    grp = torch.arange(BK, device="cuda") // K
    err, groups = 0.0, set()
    for nm, a, b in zip(names, out_k, out_p):
        if nm in ("scores", "lenm"):
            err = max(err, max_err(a[~bad_groups(groups, grp)], b[~bad_groups(groups, grp)]))
            continue
        bad = (a != b)
        bad = bad.any(dim=1) if nm == "preds" else bad.any(dim=0) if a.dim() == 2 else bad
        for g in grp[bad].unique().tolist():
            groups.add(g)
            need(float(gaps[g]) <= tie,
                 f"K4 {nm} differs in group {g}, plain candidate gap {float(gaps[g])}")
    need(bool((out_k[7] == out_p[7]).all()) or groups, "K4 all-EOS flag differs")
    c_err = max(cache_err(ck.self_k, cp.self_k, bf16), cache_err(ck.self_v, cp.self_v, bf16))
    need(not bf16 or c_err <= 1, f"K4 bf16 cache rows {c_err} bf16 steps apart")
    err = err if bf16 else max(err, c_err)
    ms = cuda_ms(lambda: run(decode_beam_step_flash, ck, anc_k), 20)
    plain_ms = cuda_ms(lambda: run(decode_beam_step_plain, cp, anc_p), 10)
    n_bytes, flops = decode_bound(cfg, cfg.dec_layers, K, i - 1, st["anc"], st["mem_mask"],
                                  ck.self_k.element_size(), quant, cfg.dec_vocab_size, K)
    # the token rows and the time signal in; the select's state in and out
    n_bytes += 4 * BK * cfg.dim_model + 4 * cfg.dim_model + 2 * nbytes(out_k)
    b = bound(n_bytes, flops)
    say(f"kernel K4 decode_beam_step {variant_label(quant, bf16)}", BK=BK, i=i,
        eos_rows=int(eos.sum()), max_abs_err=err, tol=tol, cache_err=c_err,
        tied_groups=len(groups), ms=ms,
        plain_ms=plain_ms, EOS=EOS, **b, **fused_launch(cfg, BK, K, ck, quant, bf16, True))
    need(err <= tol, f"K4 max_abs_err {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def bad_groups(groups, grp):
    """Rows of the beam groups whose selection differed by a tie (their
    scores are another candidate's, not comparable)."""
    return torch.isin(grp, torch.tensor(sorted(groups), dtype=grp.dtype, device=grp.device))


def phase_k4_select(params, cfg, rng):
    """K4's select kernel alone (`beam_select`, the general beam loop's
    k^2 -> k update) at BK = 80, a mid position, a fifth of the rows
    finished."""
    from stjep_tpu_torch.ops.decode_flash import beam_select, beam_select_plain

    K, BK, i = BEAM, B * BEAM, DECODE_LEN // 2
    st = decode_state(params, cfg, rng, i - 1)
    sc = torch.from_numpy(-np.sort(rng.uniform(0, 8, (BK, K)), 1).astype(np.float32)).cuda()
    ids = torch.from_numpy(np.stack([rng.permutation(cfg.dec_vocab_size)[:K]
                                     for _ in range(BK)]).astype(np.int32)).cuda()
    eos = torch.from_numpy((rng.rand(BK) < 0.2).astype(np.int32)).cuda()
    scores = torch.from_numpy(-rng.uniform(0, 3 * i, BK).astype(np.float32)).cuda()
    lenm = torch.from_numpy(rng.randint(1, i, BK).astype(np.float32)).cuda()
    args = (sc, ids, scores, eos, lenm, st["preds"], st["anc"], st["maskk"], i, K, 1.0)
    out_k, out_p = beam_select(*args), beam_select_plain(*args)
    names = ("preds", "anc", "maskk", "last_tok", "scores", "eos", "lenm", "flag")
    err = 0.0
    for nm, a, b in zip(names, out_k, out_p):
        if nm in ("scores", "lenm"):
            err = max(err, max_err(a, b))
        else:
            need(torch.equal(a.int(), b.int()), f"K4 select {nm} differs")
    ms = cuda_ms(lambda: beam_select(*args), 20)
    plain_ms = cuda_ms(lambda: beam_select_plain(*args), 10)
    tol = 1e-3  # K4's: cumulative scores of magnitude up to ~450 in f32
    b = bound(nbytes(args[:8], out_k), 0)
    say("kernel K4 select", BK=BK, i=i, eos_rows=int(eos.sum()), max_abs_err=err,
        tol=tol, ms=ms, plain_ms=plain_ms, **b)
    need(err <= tol, f"K4 select max_abs_err {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def phase_k5(params, cfg, rng, quant=False, bf16=False):
    """K5 (one decoder layer's decode step) at the universal beam's shapes:
    BK = 80, a mid position of the 160-row caches, 96 memory rows, its
    LayerNorms drawn at random (random_norms)."""
    from stjep_tpu_torch.ops.decode_flash import (
        decoder_layer_step_flash,
        decoder_layer_step_flash_trio,
        decoder_layer_step_plain,
    )

    K, BK, pos = BEAM, B * BEAM, DECODE_LEN // 2
    st = decode_state(params, cfg, rng, pos, bf16=bf16)
    x = torch.from_numpy(rng.randn(BK, cfg.dim_model).astype(np.float32)).cuda()
    lp = random_norms(serving_decoder(params, quant), rng)["layers"][0]

    def run(fn, cache):
        return fn(lp, x, cache.self_k[0], cache.self_v[0], cache.mem_k[0],
                  cache.mem_v[0], pos, cfg.num_heads, st["anc"], K,
                  st["mem_mask"], st["maskk"])

    ck, cp = clone_cache(st["cache"]), clone_cache(st["cache"])
    y_k, y_p = run(decoder_layer_step_flash, ck), run(decoder_layer_step_plain, cp)
    c_err = max(cache_err(ck.self_k[0], cp.self_k[0], bf16),
                cache_err(ck.self_v[0], cp.self_v[0], bf16))
    need(not bf16 or c_err <= 1, f"K5 bf16 cache rows {c_err} bf16 steps apart")
    err = max_err(y_k, y_p) if bf16 else max(max_err(y_k, y_p), c_err)
    need(bool(ck.self_k[0][:, :, pos].abs().sum() > 0), "K5 wrote no cache row")
    ms = cuda_ms(lambda: run(decoder_layer_step_flash, ck), 20)
    plain_ms = cuda_ms(lambda: run(decoder_layer_step_plain, cp), 10)
    # K5 as the trio, K6a-c's launch sequences in turn (f32 weights only), timed beside it
    ct = clone_cache(st["cache"])
    trio = {} if quant else {"trio_ms": cuda_ms(lambda: run(decoder_layer_step_flash_trio, ct),
                                                20)}
    # one layer's hidden state (|y| up to ~10) in f32, summed in another
    # order; SERVE_TOL with bf16 caches
    tol = SERVE_TOL if bf16 else 1e-4
    Lpad, Lk_pad = st["cache"].self_k.shape[3], st["cache"].mem_k.shape[2]
    b = bound(*decode_bound(cfg, 1, K, pos, st["anc"], st["mem_mask"],
                            ck.self_k.element_size(), quant))
    say(f"kernel K5 decoder_layer_step {variant_label(quant, bf16)}", BK=BK, pos=pos,
        Lpad=Lpad, Lk_pad=Lk_pad, max_abs_err=err, tol=tol, cache_err=c_err, ms=ms,
        plain_ms=plain_ms, **trio, **b, **fused_launch(cfg, BK, K, ck, quant, bf16))
    need(err <= tol, f"K5 max_abs_err {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def check_topk(name, ids, ids_p, sc_p):
    """ids [BK, k] equal to the plain arm's ids_p[:, :k] wherever its gap to
    the next rank exceeds TIE (sc_p holds k + 1 ranks); returns the number
    of rows that differ (all ties)."""
    k = ids.shape[1]
    bad = (ids != ids_p[:, :k]) & (sc_p[:, :k] - sc_p[:, 1:k + 1] > TIE)
    need(not bool(bad.any()), f"{name}: ids differ beyond ties in rows "
         f"{bad.any(1).nonzero().flatten().tolist()}")
    return int((ids != ids_p[:, :k]).any(1).sum())


def host_us(fn, n=50) -> float:
    """The host's microseconds to issue one call of fn, over n calls in a
    row after a warm-up (the stream runs behind them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def phase_k7(params, cfg, rng):
    """K7 (decode_head, decode_head_gather) at the universal beam's BK = 80
    (top-5) and universal dev eval's BK = 16 (top-1), with the model's V =
    200 and a word-level V = 30 000: against the plain versions, with the
    fused launch's grid, barriers and column slices, and for each call its
    device operations (one) and device us under torch.profiler and the
    host's us to issue it. Returns the times at the main paths' shapes (V =
    200; BK 80 for the head, 16 for the gather)."""
    from stjep_tpu_torch.ops.decode_flash import (
        decode_head,
        decode_head_gather,
        decode_head_gather_plain,
        decode_head_plain,
        fused_grid,
        fused_plan,
    )

    norm = params["dec_tgt"]["norm"]
    D, res = cfg.dim_model, {}
    # a word-level target table at 1/sqrt(D), as init_seq2seq scales out_tgt
    w_big = torch.from_numpy((rng.randn(D, 30000) / np.sqrt(D)).astype(np.float32)).cuda()
    for V, out in ((cfg.dec_vocab_size, params["out_tgt"]), (30000, {"w": w_big})):
        for BK, topk in ((B * BEAM, BEAM), (B, 1)):
            x = torch.from_numpy(rng.randn(BK, D).astype(np.float32)).cuda()
            gid = torch.from_numpy(rng.randint(0, V, BK).astype(np.int32)).cuda()
            head = lambda: decode_head(norm, out, x, topk)
            gather = lambda: decode_head_gather(norm, out, x, topk, gid)
            sc, ids = head()
            sc_g, ids_g, glp = gather()
            sc_p, ids_p = decode_head_plain(norm, out, x, topk + 1)
            _, _, glp_p = decode_head_gather_plain(norm, out, x, topk, gid)
            rows = check_topk(f"K7 V={V} BK={BK}", ids, ids_p, sc_p)
            need(torch.equal(ids, ids_g) and torch.equal(sc, sc_g),
                 "K7 head and head_gather disagree")
            err = max(max_err(sc, sc_p[:, :topk]), max_err(glp, glp_p))
            t = dict(ms=cuda_ms(head, 20),
                     plain_ms=cuda_ms(lambda: decode_head_plain(norm, out, x, topk), 10),
                     gather_ms=cuda_ms(gather, 20),
                     gather_plain_ms=cuda_ms(
                         lambda: decode_head_gather_plain(norm, out, x, topk, gid), 10))
            plan = fused_plan(BK, D, 0, 1, 0, 0, V=V, step="full_head")
            g = fused_grid(False, False, False, plan["smem"], "full_head")
            h, hg = one_launch(f"K7 V={V} BK={BK}", head), one_launch(f"K7 gather V={V}", gather)
            # log-probs of magnitude <= ~12 in f32; one LayerNorm and one
            # D = 512 product, summed in another order
            tol = 1e-5
            say("kernel K7 decode_head", V=V, BK=BK, topk=topk, max_abs_err=err,
                tol=tol, tied_rows=rows, **t, grid_blocks=min(plan["blocks"], g["blocks"]),
                barriers=plan["barriers"], slices=plan["slices"], device_ops=h["device_ops"],
                device_us=h["profiled_kernel_us"], host_us=host_us(head),
                gather_device_ops=hg["device_ops"], gather_device_us=hg["profiled_kernel_us"],
                gather_host_us=host_us(gather))
            need(err <= tol, f"K7 V={V} BK={BK} max_abs_err {err} > {tol}")
            if V == cfg.dec_vocab_size:
                # the row, the norm and the weight in; top-k (and glp) out
                n_bytes = nbytes(x, norm, out, sc, ids)
                if BK == B * BEAM:
                    res["head"] = dict(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                                       library_ms=None, **bound(n_bytes, 2 * BK * D * V))
                else:
                    res["head_gather"] = dict(
                        max_abs_err=err, ms=t["gather_ms"], plain_ms=t["gather_plain_ms"],
                        library_ms=None, **bound(n_bytes + nbytes(gid, glp), 2 * BK * D * V))
    return res


def phase_k3_gather(params, cfg, rng):
    """K3's gather variant at greedy dev eval's shapes: BK = 16 (group 1),
    a mid position, the log-prob at a reference id."""
    from stjep_tpu_torch.ops.decode_flash import (
        decode_chain_step_flash,
        decode_chain_step_plain,
        stack_decoder_layers,
    )

    pos = DECODE_LEN // 2
    st = decode_state(params, cfg, rng, pos, K=1)
    x = torch.from_numpy(rng.randn(B, cfg.dim_model).astype(np.float32)).cuda()
    gid = torch.from_numpy(rng.randint(0, cfg.dec_vocab_size, B).astype(np.int32)).cuda()
    dec = params["dec_tgt"]
    stacked = stack_decoder_layers(dec)

    def run(fn, cache, topk=2):
        return fn(stacked, dec["norm"], params["out_tgt"], x, cache.self_k,
                  cache.self_v, cache.mem_k, cache.mem_v, pos, cfg.num_heads,
                  st["anc"], 1, st["mem_mask"], st["maskk"], topk, gather_ids=gid)

    ck, cp = clone_cache(st["cache"]), clone_cache(st["cache"])
    sc_k, ids_k, glp_k = run(decode_chain_step_flash, ck)
    sc_p, ids_p, glp_p = run(decode_chain_step_plain, cp)
    rows = check_topk("K3 gather", ids_k[:, :1], ids_p, sc_p)
    err = max(max_err(sc_k, sc_p), max_err(glp_k, glp_p),
              max_err(ck.self_k, cp.self_k), max_err(ck.self_v, cp.self_v))
    ms = cuda_ms(lambda: run(decode_chain_step_flash, ck, 1), 20)
    plain_ms = cuda_ms(lambda: run(decode_chain_step_plain, cp, 1), 10)
    tol = 1e-4  # K3's: log-probs after 6 layers in f32, summed in another order
    n_bytes, flops = decode_bound(cfg, cfg.dec_layers, 1, pos, st["anc"], st["mem_mask"], 4,
                                  False, cfg.dec_vocab_size, 1)
    b = bound(n_bytes + nbytes(gid, glp_k), flops)
    say("kernel K3 gather", BK=B, pos=pos, max_abs_err=err, tol=tol,
        tied_rows=rows, ms=ms, plain_ms=plain_ms, **b,
        **fused_launch(cfg, B, 1, ck, False, False, chain=True),
        **one_launch("K3 gather", lambda: run(decode_chain_step_flash, ck, 1)))
    need(err <= tol, f"K3 gather max_abs_err {err} > {tol}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


TP_N = 4  # the TP kernel phases run one shard of 4
TP_RAN = ("K6 self_attn_step", "K6 cross_attn_step", "K6 ffn_step", "K7 head_partial")


def tp_shards(params, n):
    """shard_params of the decoder and the head over a (1, n) mesh whose
    shards all lie on the one card."""
    from stjep_tpu_torch.parallel.mesh import make_mesh, shard_params

    return shard_params({"dec_tgt": params["dec_tgt"], "out_tgt": params["out_tgt"]},
                        make_mesh(1, n, ["cuda"] * n))


def trio_plain(lp, x, ck, cv, mk, mv, pos, n_head, anc, group, mem_mask, maskk):
    """The trio's plain version: K6a-c's plain versions, residuals on."""
    from stjep_tpu_torch.ops import decode_flash as df

    y = df.self_attn_step_plain(lp["decslf_attn"], x, ck, cv, pos, n_head, anc, group, maskk)
    y = df.cross_attn_step_plain(lp["encdec_attn"], y, mk, mv, n_head, group, mem_mask)
    return df.ffn_step_plain(lp["pos_ffn"], y)


def step_launch(plan, step, bf16, fn):
    """A fused K6a, K6b, K6c or K7c launch (csrc/decode_fused.cu,
    csrc/decode_chain.cu) at this call's shapes: its grid (the plan's
    blocks, at most what the card keeps resident), grid barriers, shared
    memory a block, and the device operations of one call under
    torch.profiler after a warm-up call, which must be one, with the
    kernel's device microseconds there."""
    from stjep_tpu_torch.ops.decode_flash import fused_grid

    g = fused_grid(False, bf16, False, plan["smem"], step)
    return dict(grid_blocks=min(plan["blocks"], g["blocks"]), blocks_per_sm=g["blocks_per_sm"],
                barriers=plan["barriers"], smem_bytes=plan["smem"],
                **one_launch(f"{step} step", fn))


def phase_tp_kernels(params, cfg, rng):
    """K6a-c and K7c at one shard of TP_N at the flagship: Dq = 128 (2
    local heads), BK = 80, pos 75 of the 160-row caches, 96 memory rows,
    V/n = 50; each against its plain version (the partial outputs, residual
    off, as the TP path runs them); K6a and K6b also with bf16 caches and
    memory at one shard of 2 (Dq = 256, 4 local heads), the bf16 TP beam's
    shapes. K6a-c and K7c are one fused launch each: their lines give the
    grid, barriers, shared memory and device operations a call (one) with
    its device time. No PyTorch call computes a whole K6 step or K7c, so
    library_ms is null. The trio (K6a-c
    with residuals, no kernel of its own) on its own line too: at shard
    width against its plain version, at full width against K5, and the TP
    layer step over TP_N shards of the card, joined, against K5. Bounds
    from scripts/tp_bounds.py on this run's counts (the bf16 steps'
    attention products at the bf16 peak)."""
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops.decode_flash_tp import ModelAxis, decoder_layer_step_flash_tp
    from stjep_tpu_torch.scripts.tp_bounds import tp_kernel_work

    n, K, BK, pos = TP_N, BEAM, B * BEAM, DECODE_LEN // 2
    D, nh = cfg.dim_model, cfg.num_heads // n
    Dq = D // n
    shards = tp_shards(params, n)
    s0 = shards[0]["dec_tgt"]["layers"][0]
    st = decode_state(params, cfg, rng, pos)
    c, anc, maskk, mm = st["cache"], st["anc"], st["maskk"], st["mem_mask"]
    sl = lambda t, m=0, w=Dq: t[..., m * w:(m + 1) * w].contiguous()
    x = torch.from_numpy(rng.randn(BK, D).astype(np.float32)).cuda()
    counts = dict(B=B, K=K, D=D, FF=cfg.dim_feedforward, V=cfg.dec_vocab_size, pos=pos,
                  Lk=mm.shape[0], topk=K, self_rows=distinct_rows(anc, K, pos),
                  mem_rows=int(mm.sum()))
    work = tp_kernel_work(n, **counts)
    res, tol = {}, 1e-4  # K5's: one layer's f32 outputs, summed in another order

    def held(name, key, fn, plain, err=None, b=None, tol=tol, **extra):
        """fn against plain (or err), both timed, with the bound b (by
        default tp_bounds' `key`); said with `extra` and returned."""
        err = max_err(fn(), plain()) if err is None else err
        r = dict(max_abs_err=err, ms=cuda_ms(fn, 20), plain_ms=cuda_ms(plain, 10),
                 library_ms=None, **(b or bound(*work[key])))
        say(f"kernel {name}", BK=BK, pos=pos, tol=tol, **extra, **r)
        need(err <= tol, f"{name} max_abs_err {err} > {tol}")
        return r

    def self_step(label, shard, nh_s, caches, bf16, b=None, **extra):
        """K6a at a shard (its caches: [kernel's, plain's]) against its plain
        version, the new cache rows too, with its fused launch."""
        p = shard["decslf_attn"]
        call = lambda fn, i: fn(p, x, *caches[i], pos, nh_s, anc, K, maskk, False)
        y_k, y_p = call(df.self_attn_step, 0), call(df.self_attn_step_plain, 1)
        c_err = max(cache_err(caches[0][0], caches[1][0], bf16),
                    cache_err(caches[0][1], caches[1][1], bf16))
        need(not bf16 or c_err <= 1, f"{label} bf16 cache rows {c_err} bf16 steps apart")
        err = max_err(y_k, y_p) if bf16 else max(max_err(y_k, y_p), c_err)
        Dq_s = p["w_qs"]["w"].shape[1]
        plan = df.fused_plan(BK, D, 0, nh_s, caches[0][0].shape[2], 0, K=K, Dq=Dq_s,
                             step="self", smem_max=df.step_smem_max("self", bf16))
        return held(label, "self_attn_step", lambda: call(df.self_attn_step, 0),
                     lambda: call(df.self_attn_step_plain, 1), err, b, Dq=Dq_s,
                     cache_err=c_err, **extra,
                     **step_launch(plan, "self", bf16, lambda: call(df.self_attn_step, 0)))

    # K6a: the new cache rows too
    ck, cv = sl(c.self_k[0]), sl(c.self_v[0])
    res["K6 self_attn_step"] = self_step("K6 self_attn_step", s0, nh,
                                         [(ck.clone(), cv.clone()) for _ in range(2)], False,
                                         n_model=n)
    # K6a and K6b with bf16 caches and memory at one shard of 2, as the bf16
    # TP beam runs them; the attention's products at the bf16 peak, the
    # projections at f32's
    s2 = tp_shards(params, 2)[0]["dec_tgt"]["layers"][0]
    c2 = [(sl(c.self_k[0], w=2 * Dq).to(torch.bfloat16), sl(c.self_v[0], w=2 * Dq)
           .to(torch.bfloat16)) for _ in range(2)]
    w2b, f2b = tp_kernel_work(2, cache_itemsize=2, **counts)["self_attn_step"]
    att2 = 4 * BK * (pos + 1) * 2 * Dq
    res["self_attn bf16"] = self_step("K6 self_attn_step bf16", s2, 2 * nh, c2, True,
                                      bound(w2b, f2b - att2, bf16_flops=att2), n_model=2)

    def cross_step(label, shard, nh_s, mk, mv, b=None, tol=tol, **extra):
        """K6b at a shard over its memory K/V against its plain version,
        with its fused launch."""
        p = shard["encdec_attn"]
        bf16 = mk.dtype == torch.bfloat16
        call = lambda fn: fn(p, x, mk, mv, nh_s, K, mm, False)
        Dq_s = mk.shape[-1]
        plan = df.fused_plan(BK, D, 0, nh_s, 0, mk.shape[1], K=K, Dq=Dq_s, step="cross",
                             smem_max=df.step_smem_max("cross", bf16))
        return held(label, "cross_attn_step", lambda: call(df.cross_attn_step),
                    lambda: call(df.cross_attn_step_plain), None, b, tol, Dq=Dq_s, **extra,
                    **step_launch(plan, "cross", bf16, lambda: call(df.cross_attn_step)))

    # K6b, f32 at one shard of n and with bf16 memory at one shard of 2
    res["K6 cross_attn_step"] = cross_step("K6 cross_attn_step", s0, nh, sl(c.mem_k[0]),
                                           sl(c.mem_v[0]), n_model=n)
    w2b, f2b = tp_kernel_work(2, cache_itemsize=2, **counts)["cross_attn_step"]
    att2 = 4 * K * counts["mem_rows"] * 2 * Dq
    # bf16 memory: the kernel's query, summed split by split, rounds to the
    # neighbouring bf16 value in a few entries where the plain version's
    # does not; scripts/bf16_step_tol.py emulates that on the CPU at these
    # shapes (seeds 0-15): up to 3.6e-4, against 1.4e-3 or more for a query,
    # product or probability rounded in the wrong place
    res["cross_attn bf16"] = cross_step(
        "K6 cross_attn_step bf16", s2, 2 * nh,
        *(sl(t[0], w=2 * Dq).to(torch.bfloat16) for t in (c.mem_k, c.mem_v)),
        bound(w2b, f2b - att2, bf16_flops=att2), 1e-3, n_model=2)
    mk, mv = sl(c.mem_k[0]), sl(c.mem_v[0])
    # K6c: the hidden shard's partial
    ff = s0["pos_ffn"]
    plan = df.fused_plan(BK, D, ff["w_1"]["w"].shape[1], 1, 0, 0, step="ffn")
    res["K6 ffn_step"] = held(
        "K6 ffn_step", "ffn_step", lambda: df.ffn_step(ff, x, True),
        lambda: df.ffn_step_plain(ff, x, True), n_model=n,
        **step_launch(plan, "ffn", False, lambda: df.ffn_step(ff, x, True)))
    # the trio: at full width against K5, the TP layer step against K5, and
    # at shard 0's shapes (residuals on) against its plain version
    lp = params["dec_tgt"]["layers"][0]
    full = [(c.self_k[0].clone(), c.self_v[0].clone()) for _ in range(2)]
    y5 = df.decoder_layer_step_flash(lp, x, *full[0], c.mem_k[0], c.mem_v[0], pos,
                                     cfg.num_heads, anc, K, mm, maskk)
    yt = df.decoder_layer_step_flash_trio(lp, x, *full[1], c.mem_k[0], c.mem_v[0], pos,
                                          cfg.num_heads, anc, K, mm, maskk)
    err_k5 = max(max_err(yt, y5), max_err(full[1][0], full[0][0]))
    ys = decoder_layer_step_flash_tp(
        [sh["dec_tgt"]["layers"][0] for sh in shards], [x] * n,
        [sl(c.self_k[0], m) for m in range(n)], [sl(c.self_v[0], m) for m in range(n)],
        [sl(c.mem_k[0], m) for m in range(n)], [sl(c.mem_v[0], m) for m in range(n)],
        pos, nh, [anc] * n, K, [mm] * n, [maskk] * n, ModelAxis(["cuda"] * n))
    err_tp = max_err(ys[0], y5)
    tc = [(ck.clone(), cv.clone()) for _ in range(2)]
    trio = lambda fn, i: fn(s0, x, *tc[i], mk, mv, pos, nh, anc, K, mm, maskk)
    err = max(err_k5, err_tp, max_err(trio(df.decoder_layer_step_flash_trio, 0),
                                      trio(trio_plain, 1)))
    held("K6 trio", "trio",  # a check, not a row of the kernels line
         lambda: trio(df.decoder_layer_step_flash_trio, 0), lambda: trio(trio_plain, 1), err,
         n_model=n, full_width_err=err_k5, tp_layer_step_err=err_tp)
    # K7c: shard 0 of the head, gather ids in, above and below the shard
    norm, out0 = params["dec_tgt"]["norm"], shards[0]["out_tgt"]
    v = out0["w"].shape[1]
    gid = torch.from_numpy(rng.randint(-v, 2 * v, BK).astype(np.int32)).cuda()
    head = lambda fn, k=K: fn(norm, out0, x, k, gid)
    got, ref = head(df.decode_head_partial), head(df.decode_head_partial_plain, K + 1)
    check_topk("K7 head_partial", got[1], ref[1], ref[0])
    err = max(max_err(got[0], ref[0][:, :K]), *(max_err(a, b) for a, b in zip(got[2:], ref[2:])))
    plan = df.fused_plan(BK, D, 0, 1, 0, 0, V=v, step="head")
    res["K7 head_partial"] = held(
        "K7 head_partial", "decode_head_partial", lambda: head(df.decode_head_partial),
        lambda: head(df.decode_head_partial_plain), err, n_model=n,
        **step_launch(plan, "head", False, lambda: head(df.decode_head_partial)))
    return res


def tp_mesh(n, device="cuda"):
    """Install (n > 1) or clear (n = 0) a (1, n) mesh on the one card (or
    on the host's CPU)."""
    from stjep_tpu_torch.parallel.mesh import make_mesh
    from stjep_tpu_torch.parallel.spmd import set_kernel_mesh

    set_kernel_mesh(make_mesh(1, n, [device] * n) if n else None)


def phase_tp_beam(params, params_c, cfg, reqs):
    """ST beam-5 through forward_translate on meshes (1, 2) and (1, 4) of
    the card, and on (1, 2) with bf16 caches (the only path that launches
    the fused K6a's and K6b's bf16 variants): one
    warm-up and 2 timed requests of B=16 each, K3, K4 and K5 idle, the TP
    kernels launched. f32: tokens against the single-device card route on
    the same requests, a differing row explained by a tie at the first beam
    position where the two runs' hypotheses part (kept scores within
    E2E_MARGIN). bf16: the TP route rounds other values to bf16 than the
    single-device route (per-shard products summed after), so the two part
    in some rows; the card is held instead to the same TP route on CPU
    copies (the plain versions, the same rounding points) on all 16 rows of
    a request, each differing row explained by a tie within SERVE_MARGIN
    net of the drift of its shared prefix (`net_divergence`). Returns the
    runs' launch counts."""
    ref = [translate_timed(params, cfg, [rq], LAS_RAN)[0][0] for rq in reqs[:2]]
    runs = []
    idle = ("K3", "K4", "K5", "K7 head", "K3 bf16", "K4 bf16", "K5 bf16")
    for n, opts in ((2, {}), (TP_N, {}), (2, BF16_OPTS)):
        bf16 = bool(opts)
        # with bf16 caches K6a and K6b count under their bf16 variants, the
        # bf16 rows
        ran = LAS_RAN + ("K4 select", "K6 ffn_step", "K7 head_partial") + (
            ("self_attn bf16", "cross_attn bf16") if bf16 else TP_RAN[:2])
        tp_mesh(n)
        try:
            outs, secs, launches = translate_timed(params, cfg, reqs[:1] + reqs[:2], ran, idle,
                                                   **opts)
        finally:
            tp_mesh(0)
        runs.append(launches)
        if bf16:
            f, l = reqs[0]
            t0 = time.perf_counter()
            tp_mesh(n, "cpu")
            try:
                other = recorded_translate(params_c, cfg, f, l, "cpu", step="beam_select", **opts)
            finally:
                tp_mesh(0)
            cpu_s = time.perf_counter() - t0
            pairs, limit = [(f, l, other)], SERVE_MARGIN
        else:
            pairs = [(f, l, None) for (f, l), o, r in zip(reqs[:2], outs[1:], ref)
                     if not torch.equal(o.cpu(), r.cpu())]
            limit = E2E_MARGIN
        margins = []
        for f, l, other in pairs:
            other = other or recorded_translate(params, cfg, f, l, "cuda")
            tp_mesh(n)
            try:
                tp = recorded_translate(params, cfg, f, l, "cuda", step="beam_select", **opts)
            finally:
                tp_mesh(0)
            need(torch.equal(tp[1], other[1]), f"tp beam n={n}: ASR hypotheses differ")
            for row, col in enumerate(first_diff(tp[0], other[0])):
                if col is not None:
                    pos, m, d = net_divergence(tp[2], other[2], row)
                    say("tp beam differing row", n_model=n, bf16=bf16, row=row, position=pos,
                        margin=m, drift_before=d, net_margin=m - d)
                    # bf16: the tie is what the gap gained at the parting
                    # position, net of the drift of the shared prefix
                    margins.append(m - d if bf16 else m)
        say(f"tp beam n={n}" + (" bf16" if bf16 else ""), requests=2, batch=B,
            utt_per_s=round(2 * B / sum(secs[1:]), 3),
            request_ms=[round(x * 1e3, 1) for x in secs[1:]],
            warmup_ms=round(secs[0] * 1e3, 1), rows_differ=len(margins),
            of=B if bf16 else 2 * B, against="tp on cpu copies" if bf16 else "single device",
            max_first_divergence_margin=max(margins, default=0.0), limit=limit,
            launches={k: v for k, v in launches.items() if v},
            **({"cpu_seconds": round(cpu_s, 1)} if bf16 else {}))
        need(all(m <= limit for m in margins),
             f"tp beam n={n} bf16={bf16} rows differ beyond ties: margins {margins}")
    return runs


def phase_tp_dev_eval(params, cfg, rng):
    """forward_eval("ASR_ST") with refs at B=16 on mesh (1, 2) of the card
    against the single-device card route: preds_asr equal, preds_st equal
    or differing by a tie (the single-device route's log-probs of the two
    choices, read as picked_st with each arm's tokens as refs, within
    E2E_MARGIN), picked_* within 1e-4 on agreeing rows. Returns the main
    path's launch counts."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.infer.forward import forward_eval

    feats, lens = inputs(rng, B)
    refs = {"ref_src": torch.from_numpy(rng.randint(5, cfg.enc_vocab_size, (B, cfg.max_seq_len_src))),
            "ref_tgt": torch.from_numpy(rng.randint(5, cfg.dec_vocab_size, (B, cfg.max_seq_len_tgt)))}
    for r in refs.values():
        r[:, 0] = BOS
    run = lambda **kw: {k: v.cpu() for k, v in forward_eval(
        params, cfg, "ASR_ST", acous_feats=feats, acous_lens=lens, device="cuda",
        **{**refs, **kw}).items()}
    single = run()
    tp_mesh(2)
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        secs = time.perf_counter() - t0
        launches = read_counts(LAS_RAN + TP_RAN, ("K3 gather", "K5", "K7 head_gather"))
    finally:
        tp_mesh(0)
    need(torch.equal(out["preds_asr"], single["preds_asr"]), "tp dev eval: ASR preds differ")
    rows = first_diff(out["preds_st"], single["preds_st"])
    margins = []
    if any(c is not None for c in rows):
        at = {nm: run(ref_tgt=o["preds_st"])["picked_st"] for nm, o in (("tp", out),
                                                                       ("own", single))}
        margins = [float(abs(at["own"][r, c - 1] - at["tp"][r, c - 1]))
                   for r, c in enumerate(rows) if c is not None]
    same = [c is None for c in rows]
    err = max(max_err(out["picked_asr"], single["picked_asr"]),
              max_err(out["picked_st"][same], single["picked_st"][same]))
    tol = 1e-4
    say("tp dev eval n=2", batch=B, call_ms=round(secs * 1e3, 1), rows_differ=len(margins),
        of=B, max_first_divergence_margin=max(margins, default=0.0), limit=E2E_MARGIN,
        picked_max_abs_err=err, tol=tol, launches={k: v for k, v in launches.items() if v})
    need(all(m <= E2E_MARGIN for m in margins), f"tp dev eval rows differ beyond ties: {margins}")
    need(err <= tol, f"tp dev eval picked max_abs_err {err} > {tol}")
    return launches


PROFILE_TRIES = 8


def device_ops(fn, with_us=False):
    """The device operations of one call of fn under torch.profiler (fn
    warmed up before): their count and their names (a kernel's without its
    namespace and arguments), and with with_us their summed device
    microseconds. A profile that records no device operation at all is
    taken again, up to PROFILE_TRIES times, a little later each time (the
    profiler records none in ~1 % of profiles, several in a row at times,
    PERF.md section 7); the last one counts."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_TRIES):
        time.sleep(0.1 * attempt)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs:
            break
    short = {e.name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]
             .split()[-1] for e in evs}
    if with_us:
        return len(evs), sorted(short), sum(e.time_range.elapsed_us() for e in evs)
    return len(evs), sorted(short)


def las_launch(kind, plan):
    """A fused K2 / K9 launch's shape (csrc/las_fused.cu): grid, grid
    barriers a call, shared memory a block."""
    from stjep_tpu_torch.ops.las_flash import las_grid

    g = las_grid(kind, plan["smem"])
    return (f"{g['blocks']}blocks({g['blocks_per_sm']}/SM):{plan['barriers']}barriers:"
            f"{plan['smem']}B")


def rel_err(a, b) -> float:
    """max |a - b| relative to max |b| (b: the plain version's tensor)."""
    scale = float(b.double().abs().max().cpu())
    return max_err(a, b) / scale if scale > 0 else max_err(a, b)


def phase_k8(params, cfg, rng):
    """K8 forward and backward at the four pyramid shapes of the main path."""
    from stjep_tpu_torch.ops import lstm_pallas_bwd as k8

    enc = params["las"]["encoder"]
    H = cfg.acous_hidden_size
    lens = torch.from_numpy(rng.randint(FRAMES // 2, FRAMES, size=(B,))).cuda()
    lens[0] = FRAMES
    T, din = FRAMES, cfg.acous_dim
    err = {"fwd": 0.0, "bwd": 0.0}
    rel = {"fwd": 0.0, "bwd": 0.0}
    ms = {k: 0.0 for k in ("fwd", "bwd", "plain_fwd", "plain_bwd", "lib_fwd", "lib_bwd",
                           "sweep_fwd")}
    n_bytes, flops = {"fwd": 0, "bwd": 0}, {"fwd": 0, "bwd": 0}
    for li in range(cfg.num_pyramid_layers):
        p = enc[f"acous_enc_l{li + 1}"]
        w = tuple((p["fwd"][k], p["bwd"][k]) for k in ("w_ih", "w_hh"))
        bias = tuple(q["b_ih"] + q["b_hh"] for q in (p["fwd"], p["bwd"]))
        x = torch.from_numpy(rng.uniform(-1, 1, (B, T, din)).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.randn(B, T, 2 * H).astype(np.float32)).cuda()
        fargs = (*w, bias, x, lens)
        plain = k8.bilstm_fwd_save_plain(*fargs)
        fwd = k8.bilstm_fwd_save(*fargs)
        for a, b in zip(fwd, plain):
            err["fwd"], rel["fwd"] = max(err["fwd"], max_err(a, b)), max(rel["fwd"], rel_err(a, b))
        bargs = (g, plain[2], plain[3], w[1], lens)
        a, b = k8.bilstm_bwd(*bargs), k8.bilstm_bwd_plain(*bargs)
        err["bwd"], rel["bwd"] = max(err["bwd"], max_err(a, b)), max(rel["bwd"], rel_err(a, b))
        ms["fwd"] += cuda_ms(lambda: k8.bilstm_fwd_save(*fargs), 3)
        ms["sweep_fwd"] += cuda_ms(sweep_call(p, x, lens, save=True), 3)
        ms["plain_fwd"] += cuda_ms(lambda: k8.bilstm_fwd_save_plain(*fargs), 1)
        ms["bwd"] += cuda_ms(lambda: k8.bilstm_bwd(*bargs), 3)
        ms["plain_bwd"] += cuda_ms(lambda: k8.bilstm_bwd_plain(*bargs), 1)
        n_bytes["fwd"] += nbytes(fargs, fwd)
        n_bytes["bwd"] += nbytes(bargs, a)
        flops["fwd"] += lstm_flops(lens, din, H)
        flops["bwd"] += 2 * int(lens.sum()) * 2 * H * 4 * H  # dPre @ W_hh^T per direction
        # cuDNN's training forward, and its backward (every gradient) alone
        lstm, xp = cudnn_bilstm(p, din, H, train=True), packed(x.requires_grad_(True), lens)
        ms["lib_fwd"] += cuda_ms(lambda: lstm(xp), 3)
        yp = lstm(xp)[0]
        gp = packed(g, lens).data
        ms["lib_bwd"] += cuda_ms(lambda: torch.autograd.grad(
            yp.data, [x, *lstm.parameters()], gp, retain_graph=True), 3)
        x.requires_grad_(False)
        T, din, lens = T // 2, 4 * H, lens // 2
    # f32 on both sides, other summation orders in the 256-long products of
    # each step, carried through up to 1504 serial steps: the forward's
    # states are bounded (|h| < 1), the backward's carried dc is not
    tol = {"fwd": 1e-4, "bwd": 1e-3}
    res = {}
    for k in ("fwd", "bwd"):
        res[k] = dict(max_abs_err=err[k], ms=ms[k], plain_ms=ms[f"plain_{k}"],
                      library_ms=ms[f"lib_{k}"], **bound(n_bytes[k], flops[k]))
        # the backward launches the sweep alone (the weight gradients are
        # stream matmuls after it), so its sweep time is its time
        say(f"kernel K8 bilstm_{k}", B=B, layers=cfg.num_pyramid_layers,
            max_rel_err=rel[k], tol_rel=tol[k], **res[k],
            sweep_ms=ms["sweep_fwd"] if k == "fwd" else ms["bwd"],
            cluster=plan_text(B, H, backward=k == "bwd"))
        need(rel[k] <= tol[k], f"K8 {k} relative error {rel[k]} > {tol[k]}")
    return res


def phase_k9(params, cfg, rng):
    """K9 forward and backward at the main path's shapes: S = 89 steps,
    Tk = 188 keys, with dropout masks (keep 0.8)."""
    from stjep_tpu_torch.ops import las_tf_flash as k9
    from stjep_tpu_torch.ops.las_flash import las_plan

    dec = params["las"]["decoder"]
    S, Tk = cfg.max_seq_len_src - 1, FRAMES // 8
    Hd, Ha2, E = cfg.dim_model, 2 * cfg.acous_hidden_size, cfg.enc_embedding_size
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    keep = 1.0 - cfg.dropout
    w = k9.scan_weights(*(dec[k][n] for k, n in (
        ("dec_l0", "w_ih"), ("dec_l0", "w_hh"), ("dec_l1", "w_ih"), ("dec_l1", "w_hh"),
        ("dec_l1", "b_ih"), ("dec_l1", "b_hh"), ("dec_l2", "w_ih"), ("dec_l2", "w_hh"),
        ("dec_l2", "b_ih"), ("dec_l2", "b_hh"))), dec["acous_ffn"]["w"], pack=True)
    ids = torch.from_numpy(rng.randint(5, cfg.enc_vocab_size, (S, B))).cuda()
    p0 = dec["dec_l0"]
    pre0 = (dec["embedder"][ids] @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]).contiguous()
    acous = t(rng.uniform(-1, 1, (B, Tk, Ha2)))
    wk = (acous @ dec["acous_att"]["linear_att_w"]["w"]).contiguous()
    lens = torch.from_numpy(rng.randint(Tk // 2, Tk + 1, size=(B,))).cuda()
    masks = k9.Masks(t((rng.rand(S, 3, B, Hd) < keep) / keep),
                     t((rng.rand(S, B, Ha2) < keep) / keep))
    g = t(rng.randn(S, B, Hd))
    fargs = (w, pre0, wk, acous, lens, masks)
    st = k9.las_tf_fwd_plain(*fargs)
    err, rel = {}, {}
    pairs = {"fwd": zip(k9.las_tf_fwd(*fargs), st)}
    bargs = (w, st, g, wk, acous, masks)
    pairs["bwd"] = zip(k9.las_tf_bwd(*bargs), k9.las_tf_bwd_plain(*bargs))
    for k, zs in pairs.items():
        zs = list(zs)
        err[k] = max(max_err(a, b) for a, b in zs)
        rel[k] = max(rel_err(a, b) for a, b in zs)
    ms = {"fwd": cuda_ms(lambda: k9.las_tf_fwd(*fargs), 5),
          "plain_fwd": cuda_ms(lambda: k9.las_tf_fwd_plain(*fargs), 3),
          "bwd": cuda_ms(lambda: k9.las_tf_bwd(*bargs), 5),
          "plain_bwd": cuda_ms(lambda: k9.las_tf_bwd_plain(*bargs), 3)}
    ops = {"fwd": device_ops(lambda: k9.las_tf_fwd(*fargs)),
           "bwd": device_ops(lambda: k9.las_tf_bwd(*bargs))}
    for k, (n_ops, names) in ops.items():
        need(n_ops == 1, f"K9 {k}: {n_ops} device operations a call ({names}), not one launch")
    # dynamic embeddings are unbounded FFN outputs fed back through 89
    # recurrent steps (K2's tolerance), and the backward sums over them;
    # f32 on both sides, summed in another order
    tol = 1e-3
    # per step: the three cells' and the FFN's products, the attention over
    # the Tk keys and values; backward the same products through the
    # transposed weights and twice the attention's
    mats = sum(t.numel() for t in (w.w0, w.w1, w.w2, w.ffn))
    att = 2 * B * Tk * (Hd + Ha2)
    step_flops = {"fwd": 2 * B * mats + att, "bwd": 2 * B * mats + 2 * att}
    io = {"fwd": nbytes(fargs, st), "bwd": nbytes(bargs, k9.las_tf_bwd(*bargs))}
    res = {}
    for k in ("fwd", "bwd"):
        res[k] = dict(max_abs_err=err[k], ms=ms[k], plain_ms=ms[f"plain_{k}"],
                      library_ms=None, **bound(io[k], S * step_flops[k]))
        plan = las_plan(f"tf_{k}", B, Tk, Hd, w.ffn.shape[1], Ha2, steps=S)
        say(f"kernel K9 las_tf_{k}", steps=S, B=B, Tk=Tk, max_rel_err=rel[k], tol_rel=tol,
            device_ops_per_call=ops[k][0], device_kernels=",".join(ops[k][1]),
            fused=las_launch(f"tf_{k}", plan), **res[k])
        need(rel[k] <= tol, f"K9 {k} relative error {rel[k]} > {tol}")
    return res


def train_batch(rng, cfg, n, frames):
    """bench.py's train inputs: fbank-shaped features with lengths in
    [frames/2, frames-8] (one at frames-8), random source and target ids."""
    feats = torch.from_numpy(rng.randn(n, frames, cfg.acous_dim).astype(np.float32))
    lens = torch.from_numpy(rng.randint(frames // 2, frames - 8, size=(n,)))
    lens[0] = frames - 8
    src = rng.randint(5, cfg.enc_vocab_size, (n, cfg.max_seq_len_src))
    tgt = rng.randint(5, cfg.dec_vocab_size, (n, cfg.max_seq_len_tgt))
    return {"srcid": torch.from_numpy(src), "tgtid": torch.from_numpy(tgt),
            "acous_feat": feats, "acouslen": lens}


@contextlib.contextmanager
def relu_patterns(replay=None):
    """While active, torch.relu (the transformer FFNs' only nonlinearity
    with a kink) records each call's pattern, input > 0, in call order; the
    context yields that list. Given `replay`, another arm's recorded list,
    it returns x * pattern instead: the same linear piece that arm's step
    took, so that the two differ by rounding alone."""
    seen, relu = [], torch.relu

    def patched(x):
        seen.append((x > 0).detach().cpu())
        if replay is None:
            return relu(x)
        return x * replay[len(seen) - 1].to(x.device, x.dtype)

    torch.relu = patched
    try:
        yield seen
    finally:
        torch.relu = relu


def train_parity_readings(seed):
    """One deterministic ASR_ST step, made from `seed` alone: the kernel
    route on the card and the plain route on CPU copies, both f32, each
    against the plain route in float64 that takes the same ReLU pieces (a
    pre-activation within rounding of 0 flips the ReLU's gradient between
    0 and 1, so an f32 arm and float64 may take different pieces: that
    moves the FFN's leaves by a finite step and is no fault). Returns the
    readings, with `leaves`: (name, card error, CPU error) per gradient
    leaf, each the relative norm of the difference from its float64 arm."""
    from stjep_tpu_torch.bridge import leaves, named_leaves, params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.train.optim import make_optimizer, set_lr
    from stjep_tpu_torch.train.trainer import compute_grads

    cfg = ModelConfig(**{**FLAGSHIP, "dropout": 0.0, "spec_aug": False,
                         "embedding_dropout": 0.0})
    params_c = init_seq2seq(cfg, torch.Generator().manual_seed(seed + 1), "cpu")
    mb = train_batch(np.random.RandomState(seed), cfg, PARITY_B, PARITY_FRAMES)
    # copies made before any step, which updates its arm's tree in place
    trees = {"card": params_to(params_c, "cuda"), "cpu": params_c,
             "f64 card": params_to(params_c, torch.float64),
             "f64 cpu": params_to(params_c, torch.float64)}
    arms, secs, pats, flips = {}, {}, {}, {}
    for arm, dev, dt in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                         ("f64 card", "cpu", torch.float64), ("f64 cpu", "cpu", torch.float64)):
        p = trees[arm]
        batch = {k: v.to(dev, dt if v.is_floating_point() else v.dtype) for k, v in mb.items()}
        replay = pats.get(arm.split()[-1]) if arm.startswith("f64") else None
        t0 = time.perf_counter()
        with relu_patterns(replay) as seen:
            losses, grads = compute_grads(cfg, "ASR_ST", p, [batch],
                                          torch.Generator().manual_seed(seed),
                                          is_training=False)
        if replay is None:
            pats[arm] = seen
        else:  # entries where float64's own sign differs from the replayed one
            flips[arm] = sum(int((a != b).sum()) for a, b in zip(seen, replay))
        before = [t_.detach().clone() for t_ in leaves(p)]
        opt = make_optimizer(1.0)
        opt.update(grads, set_lr(opt.init(p), TRAIN_LR))
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[arm] = time.perf_counter() - t0
        moved = [a.detach() - b for a, b in zip(leaves(p), before)]
        arms[arm] = (float(sum(losses.values())), [g_.cpu().double() for g_ in grads],
                     [m.cpu().double() for m in moved])
    names = [n for n, _ in named_leaves(params_c)]

    def rel(xs, ys):
        return [float((a - b).norm() / b.norm()) if float(b.norm()) > 0
                else float(a.abs().max()) for a, b in zip(xs, ys)]

    e_card = rel(arms["card"][1], arms["f64 card"][1])
    e_cpu = rel(arms["cpu"][1], arms["f64 cpu"][1])
    e_pair = rel(arms["card"][1], arms["cpu"][1])  # card against CPU, no shared pieces
    wc, wq, wp = (max(zip(e, names)) for e in (e_card, e_cpu, e_pair))
    # Adam's first step moves a coordinate by -lr * g / (|g| + eps), about
    # lr * sign(g): where g is near zero the arms' rounding can move it the
    # other way. So each arm's step is held to that formula from its OWN
    # gradients (float64; 1e-2 lr covers f32 rounding of |p| < 8)
    formula_err = {arm: max(float((m - u).abs().max()) / TRAIN_LR
                            for m, u in zip(moved, adam_first_step(grads)))
                   for arm, (_, grads, moved) in arms.items()}
    loss_rel = {a: abs(arms[a][0] - arms[f"f64 {a}"][0]) / abs(arms[f"f64 {a}"][0])
                for a in ("card", "cpu")}
    return dict(seed=seed, loss_card=arms["card"][0], loss_f64=arms["f64 card"][0],
                loss_rel_card=loss_rel["card"], loss_rel_cpu=loss_rel["cpu"],
                worst_grad_card=wc[0], worst_leaf_card=wc[1],
                worst_grad_cpu=wq[0], worst_leaf_cpu=wq[1],
                relu_entries=sum(t.numel() for t in pats["card"]),
                relu_flips_card_cpu=sum(int((a != b).sum())
                                        for a, b in zip(pats["card"], pats["cpu"])),
                relu_flips_card_f64=flips["f64 card"], relu_flips_cpu_f64=flips["f64 cpu"],
                card_vs_cpu_worst_grad=wp[0], card_vs_cpu_worst_leaf=wp[1],
                adam_step_err_lr_card=formula_err["card"],
                adam_step_err_lr_cpu=formula_err["cpu"],
                card_s=round(secs["card"], 3), cpu_s=round(secs["cpu"], 3),
                f64_s=round(secs["f64 card"], 3), leaves=list(zip(names, e_card, e_cpu, e_pair)))


def phase_train_parity(seed):
    """train_parity_readings held to its limits: the loss to 1e-4 and every
    gradient leaf to PARITY_TOL of its norm, against float64 on the same
    ReLU pieces; each arm's Adam step to its formula."""
    r = train_parity_readings(seed)
    say("train parity", B=PARITY_B, frames=PARITY_FRAMES,
        **{k: v for k, v in r.items() if k != "leaves"}, tol_loss=1e-4,
        tol_grad=PARITY_TOL, tol_adam=1e-2)
    need(r["loss_rel_card"] <= 1e-4, f"train parity loss {r['loss_card']} vs f64 {r['loss_f64']}")
    need(r["worst_grad_card"] <= PARITY_TOL,
         f"train parity gradient {r['worst_leaf_card']}: {r['worst_grad_card']} of its "
         f"norm from float64 > {PARITY_TOL}")
    need(max(r["adam_step_err_lr_card"], r["adam_step_err_lr_cpu"]) <= 1e-2,
         f"train parity Adam step: card {r['adam_step_err_lr_card']}, cpu {r['adam_step_err_lr_cpu']}")


def adam_first_step(grads, max_norm: float = 1.0, eps: float = 1e-8):
    """Adam's first update from raw gradients, in float64: optax's global
    clip, then -lr * g / (|g| + eps) (the bias corrections cancel)."""
    gs = [g.double() for g in grads]
    norm = sum(float((g * g).sum()) for g in gs) ** 0.5
    if norm >= max_norm:
        gs = [g / norm * max_norm for g in gs]
    return [-TRAIN_LR * g / (g.abs() + eps) for g in gs]


def phase_train_e2e(seed, rng):
    """make_train_step at the flagship; returns the main path's launch
    counts."""
    from stjep_tpu_torch.bridge import leaves, named_leaves, params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.trainer import make_train_step

    cfg = ModelConfig(**FLAGSHIP)
    params = params_to(init_seq2seq(cfg, torch.Generator().manual_seed(seed + 2), "cpu"),
                       "cuda")
    mb = {k: v.cuda() for k, v in train_batch(rng, cfg, B, FRAMES).items()}
    opt = make_optimizer(1.0)
    opt_state = opt.init(params)
    step = make_train_step(cfg, "ASR_ST", opt, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = [t.detach().clone() for t in leaves(params)]
    losses, secs = [], []
    for i in range(7):  # 2 warm-up steps, then 5 timed
        t0 = time.perf_counter()
        params, opt_state, ls = step(params, opt_state, [mb], gen, TRAIN_LR)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(sum(ls.values())))
        if i == 0:
            still = [nm for (nm, a), b in zip(named_leaves(params), before)
                     if torch.equal(a.detach(), b) and nm != "/emb_dyn_ave"]
            need(not still, f"parameters unchanged by a train step: {still}")
    launches = read_counts(("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"))
    timed = secs[2:]
    say("train e2e", mode="ASR_ST", B=B, frames=FRAMES, steps_per_s=len(timed) / sum(timed),
        step_ms=[round(x * 1e3, 3) for x in timed],
        warmup_ms=[round(x * 1e3, 3) for x in secs[:2]], losses=losses,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches={k: n for k, n in launches.items() if n})
    need(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    return launches


def recorded_translate(params, cfg, feats, lens, device, step=None, **opts):
    """forward_translate ST beam-5 on `device` (opts: its serving options)
    that also records, at every beam position, the state handed on (tokens
    [BK, L] and kept scores [BK], on the host), starting with the state
    after position 1: the megastep's output for the standard decoder, the
    general loop's select for the universal one; `step` names the hooked
    function where the route is not the model's own (the general loop's
    "beam_select" under tensor parallelism). Returns (tokens [B, L], ASR
    hypotheses, states)."""
    import stjep_tpu_torch.infer.beam as beam_mod
    from stjep_tpu_torch.infer.forward import encode_st, forward_translate

    # the function that hands the state on, and where its input preds and
    # kept scores sit among its arguments
    step = step or ("decode_beam_step_flash" if cfg.transformer_type == "standard"
                    else "beam_select")
    name, i_preds, i_scores = (step, 7, 11) if step == "decode_beam_step_flash" else (step, 5, 2)
    step, states = getattr(beam_mod, name), []

    def recording(*a):
        if not states:  # the state after position 1: the first step's input
            states.append((a[i_preds].cpu(), a[i_scores].cpu()))
        out = step(*a)
        states.append((out[0].cpu(), out[4].cpu()))
        return out

    setattr(beam_mod, name, recording)
    try:
        toks = forward_translate(params, cfg, "ST", acous_feats=feats,
                                 acous_lens=lens, beam_width=BEAM,
                                 penalty_factor=1.0, max_seq_len=DECODE_LEN,
                                 device=device, **opts)
    finally:
        setattr(beam_mod, name, step)
    feats, lens = feats.to(device), lens.to(device)
    return toks.cpu(), encode_st(params, cfg, feats, lens)[2].cpu(), states


def explain_e2e(params_c, cfg, feats, lens, card, plain, net=False, raw_rows=()):
    """Every row where the card's tokens differ from the plain arm's must be
    explained by a tie at the first divergence, in the plain arm's own
    log-probs: if the ASR hypotheses differ, the plain LAS log-probs of the
    two symbols at their first difference; else, at the first beam position
    where the row's K hypotheses differ, the two arms' kept beam scores
    (sums of log-probs), sorted, within E2E_MARGIN; with net (bf16 caches,
    which drift ~3e-3 a position between two routes) that gap less the
    row's drift at the position before (`net_divergence`), except on the
    rows in raw_rows, held at the whole gap. Returns the margins."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.models.las_encoder import las_encoder_forward
    from stjep_tpu_torch.ops.attention import precompute_keys
    from stjep_tpu_torch.ops.las_flash import las_greedy_plain
    from stjep_tpu_torch.ops.masks import round_up8

    (toks_c, hyp_c, st_c), (toks_p, hyp_p, st_p) = card, plain
    dec = params_c["las"]["decoder"]
    acous, _ = las_encoder_forward(params_c["las"]["encoder"], cfg, feats, lens)
    args = (dec, cfg, precompute_keys(dec["acous_att"], acous, "bilinear")["wk"],
            acous, round_up8(lens) // 8, torch.full((feats.shape[0],), BOS),
            cfg.max_seq_len_src - 1)
    at_card = las_greedy_plain(*args, ref_tokens=hyp_c)[2]
    at_own = las_greedy_plain(*args, ref_tokens=hyp_p)[2]
    las_rows = first_diff(hyp_c, hyp_p)
    margins = []
    for r, c in enumerate(first_diff(toks_c, toks_p)):
        if c is None:
            continue
        h = las_rows[r]
        drift = 0.0
        if h is not None:
            stage, pos, m = "las", h, float(abs(at_own[r, h] - at_card[r, h]))
        elif net:
            stage, (pos, m, drift) = "beam", net_divergence(st_c, st_p, r)
        else:
            stage, (pos, m) = "beam", beam_divergence(st_c, st_p, r)
        say("e2e differing row", row=r, stage=stage, position=pos, col=c,
            margin=m, **({"drift_before": drift, "net_margin": m - drift} if net else {}))
        margins.append(m if r in raw_rows else m - drift)
    return margins


def net_divergence(st_c, st_p, r):
    """(position, margin, drift): beam_divergence's parting position and
    margin for row r, and the row's drift at the position before, where
    its hypotheses still agreed: the largest gap between the two runs'
    sorted kept scores there (0 before the first recorded state). With bf16
    caches two routes drift apart by ~3e-3 a position (rounding flips from
    other summation orders; stjep_tpu_torch/scripts/bf16_drift.py), so over
    a long shared prefix the margin holds that drift as well as the tie;
    margin - drift is what the gap gained at the parting position. Fails
    if the drift passes BF16_DRIFT times the parting position: a route
    that drifts further computes another function, not a rounding."""
    pos, m = beam_divergence(st_c, st_p, r)
    if pos is None or pos < 2:
        return pos, m, 0.0
    g = slice(r * BEAM, (r + 1) * BEAM)
    (_, sc), (_, sp) = st_c[pos - 2], st_p[pos - 2]
    drift = float((sc[g].sort()[0] - sp[g].sort()[0]).abs().max())
    need(drift <= BF16_DRIFT * pos,
         f"row {r} drifted {drift} before position {pos}, past {BF16_DRIFT} a position")
    return pos, m, drift


def beam_divergence(st_c, st_p, r):
    """(position, margin): the first beam position where row r's K
    hypotheses differ between two recorded runs, and the largest gap there
    between the two runs' kept beam scores, sorted (inf if none differ)."""
    g = slice(r * BEAM, (r + 1) * BEAM)
    for t, ((pc, sc), (pp, sp)) in enumerate(zip(st_c, st_p)):
        if not torch.equal(pc[g], pp[g]):
            return t + 1, float((sc[g].sort()[0] - sp[g].sort()[0]).abs().max())
    return None, float("inf")


def counters():
    """Every kernel wrapper's launch counter: name -> (wrapper, attribute)."""
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops import las_tf_flash as k9
    from stjep_tpu_torch.ops import lstm_pallas_bwd as k8
    from stjep_tpu_torch.ops.las_flash import las_greedy_flash
    from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas

    out = {"K1": (bilstm_pallas, "launches"), "K2": (las_greedy_flash, "launches"),
           "K3 gather": (df.decode_chain_step_flash, "gather_launches"),
           "K4 select": (df.beam_select, "launches"),
           "K7 head": (df.decode_head, "launches"),
           "K7 head_gather": (df.decode_head_gather, "launches"),
           "K8 fwd": (k8.bilstm_fwd_save, "launches"), "K8 bwd": (k8.bilstm_bwd, "launches"),
           "K9 fwd": (k9.las_tf_fwd, "launches"), "K9 bwd": (k9.las_tf_bwd, "launches"),
           "self_attn bf16": (df.self_attn_step, "bf16_launches"),
           "cross_attn bf16": (df.cross_attn_step, "bf16_launches"),
           "K6 self_attn_step": (df.self_attn_step, "launches"),
           "K6 cross_attn_step": (df.cross_attn_step, "launches"),
           "K6 ffn_step": (df.ffn_step, "launches"),
           "K7 head_partial": (df.decode_head_partial, "launches")}
    for k, fn in (("K3", df.decode_chain_step_flash), ("K4", df.decode_beam_step_flash),
                  ("K5", df.decoder_layer_step_flash)):
        for quant, bf16 in VARIANTS:
            label = k if not (quant or bf16) else f"{k} {variant_label(quant, bf16)}"
            out[label] = (fn, ("q8_" if quant else "") + ("bf16_" if bf16 else "") + "launches")
    return out


VARIANTS = ((False, False), (True, False), (False, True), (True, True))


def zero_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts(ran, idle=()):
    """The counts since zero_counts(); fails unless every kernel in `ran`
    launched and none in `idle` did."""
    got = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    need(all(got[k] > 0 for k in ran) and not any(got[k] for k in idle),
         f"launch counts {got}: expected > 0 for {list(ran)}, 0 for {list(idle)}")
    return got


def phase_beam_e2e(label, params, params_c, cfg, reqs, gen, ran, idle=()):
    """forward_translate ST beam 5 on the requests (B=16 each) and a B=1
    latency, then the plain arm on CPU copies for request 0 with every
    differing row explained by a tie. Returns the main path's launch
    counts (the timed requests only)."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.infer.forward import forward_translate

    # host inputs: the call moves them to the card, inside the timed region
    call = lambda f, l: forward_translate(params, cfg, "ST", acous_feats=f,
                                          acous_lens=l, beam_width=BEAM,
                                          penalty_factor=1.0,
                                          max_seq_len=DECODE_LEN,
                                          device="cuda", generator=gen)
    zero_counts()
    outs, secs = [], []
    for f, l in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(call(f, l))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = read_counts(ran, idle)
    for o in outs:
        need(o.shape == (B, DECODE_LEN) and bool((o[:, 0] == BOS).all())
             and bool(((o >= 0) & (o < cfg.dec_vocab_size)).all()),
             f"{label} output shape/range")
    f1, l1 = reqs[0][0][:1], reqs[0][1][:1]
    lat = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(f1, l1)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    say(label, transformer=cfg.transformer_type, requests=len(reqs), batch=B,
        utt_per_s=round(B * len(reqs) / sum(secs), 3),
        request_ms=[round(s * 1e3, 1) for s in secs],
        b1_latency_ms=round(statistics.median(lat) * 1e3, 1),
        launches={k: n for k, n in launches.items() if n})

    # the plain arm: the same call on CPU copies, for request 0
    feats, lens = reqs[0]
    t0 = time.perf_counter()
    plain = recorded_translate(params_c, cfg, feats, lens, "cpu")
    plain_s = time.perf_counter() - t0
    card = recorded_translate(params, cfg, feats, lens, "cuda")
    need(torch.equal(card[0], outs[0].cpu()), f"{label}: card run not reproducible")
    margins = explain_e2e(params_c, cfg, feats, lens, card, plain)
    say(f"{label} plain arm", device="cpu", seconds=round(plain_s, 1),
        rows_differ=len(margins), of=B,
        max_first_divergence_margin=max(margins, default=0.0), limit=E2E_MARGIN)
    need(all(m <= E2E_MARGIN for m in margins),
         f"{label} rows differ beyond ties: margins {margins}")
    return launches


def snap_int8_grid(params_c, seed):
    """A copy of the params whose streamed decoder matrices sit on the int8
    grid (scripts/check_int8_tpu.py `snap`): w = q * 2^-12, integer q with
    127 in row 0 of every column, from the seed's own stream, so that
    quantize_decoder_weights recovers (q, s) exactly and int8 decoding is
    lossless."""
    from stjep_tpu_torch.ops.decode_flash import QUANT_CROSS, QUANT_FFN, QUANT_SELF

    rng = np.random.RandomState(seed + 3)
    layers = []
    for lp in params_c["dec_tgt"]["layers"]:
        nl = dict(lp)
        for sub, keys in (("decslf_attn", QUANT_SELF), ("encdec_attn", QUANT_CROSS),
                          ("pos_ffn", QUANT_FFN)):
            nl[sub] = dict(lp[sub])
            for k in keys:
                q = rng.randint(-127, 128, size=tuple(lp[sub][k]["w"].shape))
                q[0] = 127
                nl[sub][k] = {**lp[sub][k], "w": torch.from_numpy((q * 2.0 ** -12)
                                                                  .astype(np.float32))}
        layers.append(nl)
    return {**params_c, "dec_tgt": {**params_c["dec_tgt"], "layers": layers}}


def translate_timed(params, cfg, reqs, ran, idle=(), **opts):
    """forward_translate ST beam-5 on the card over the requests (host
    inputs, moved inside the call), every launch count zeroed just before
    and read just after. Returns (outputs, seconds per request, launches)."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.infer.forward import forward_translate

    zero_counts()
    outs, secs = [], []
    for f, l in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(forward_translate(params, cfg, "ST", acous_feats=f, acous_lens=l,
                                      beam_width=BEAM, penalty_factor=1.0,
                                      max_seq_len=DECODE_LEN, device="cuda", **opts))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = read_counts(ran, idle)
    for o, (f, _) in zip(outs, reqs):
        need(o.shape == (f.shape[0], DECODE_LEN) and bool((o[:, 0] == BOS).all())
             and bool(((o >= 0) & (o < cfg.dec_vocab_size)).all()), "serving output shape/range")
    return outs, secs, launches


BF16_OPTS = {"cache_dtype": torch.bfloat16}
SERVE_OPTS = {"cache_dtype": torch.bfloat16, "weight_dtype": "int8"}
LAS_RAN = ("K1", "K2")


def phase_serving(params, params_c, cfg, reqs, rng, seed):
    """The serving decode on the standard model, each call a main path with
    its launch counts: bf16 caches at B=16 (utt/s), B=1 (median latency)
    and B=64 (one request); int8 weights + bf16 caches at B=1 and B=16.
    Then: on weights snapped to the int8 grid the int8 route decodes the
    f32 route's tokens on the card in every row; and the bf16 route on the
    card against its plain route on CPU copies on the 16 rows of a request,
    every differing row explained by a tie within SERVE_MARGIN net of the
    drift of its shared prefix (`net_divergence`), as the bf16 TP beam is
    held, and rows 0 and 1 within SERVE_MARGIN whole. Returns the launch
    counts of every run."""
    from stjep_tpu_torch.bridge import params_to

    b1 = [(f[:1], l[:1]) for f, l in reqs]
    big = inputs(rng, 4 * B)
    runs, rec = [], {}
    bf16_ran = LAS_RAN + ("K3 bf16", "K4 bf16")
    serve_ran = LAS_RAN + ("K3 int8+bf16", "K4 int8+bf16")
    # the fused K4 and K5 run their own attention: the bf16 rows of the TP
    # steps (K6a's and K6b's) launch only under tensor parallelism
    # (phase_tp_beam)
    f32_idle = ("K3", "K4", "K5", "self_attn bf16", "cross_attn bf16")
    for label, rq, opts, ran in (("bf16 B=16", reqs, BF16_OPTS, bf16_ran),
                                 ("bf16 B=1", b1, BF16_OPTS, bf16_ran),
                                 ("bf16 B=64", [big], BF16_OPTS, bf16_ran),
                                 ("int8+bf16 B=1", b1, SERVE_OPTS, serve_ran),
                                 ("int8+bf16 B=16", reqs, SERVE_OPTS, serve_ran)):
        _, secs, launches = translate_timed(params, cfg, rq, ran, f32_idle, **opts)
        n = sum(f.shape[0] for f, _ in rq)
        rec[label] = dict(utt_per_s=round(n / sum(secs), 3),
                          request_ms=[round(x * 1e3, 1) for x in secs],
                          median_ms=round(statistics.median(secs) * 1e3, 1))
        say(f"serving {label}", requests=len(rq), batch=rq[0][0].shape[0], **rec[label],
            launches={k: v for k, v in launches.items() if v})
        runs.append(launches)

    # int8 on the int8 grid: the f32 route's tokens, every row
    snapped = params_to(snap_int8_grid(params_c, seed), "cuda")
    f32_out = translate_timed(snapped, cfg, reqs[:1], LAS_RAN + ("K3", "K4"))[0][0]
    q8_out, _, launches = translate_timed(snapped, cfg, reqs[:1],
                                          LAS_RAN + ("K3 int8", "K4 int8"), ("K3", "K4"),
                                          weight_dtype="int8")
    runs.append(launches)
    same = int((f32_out == q8_out[0]).all(dim=1).sum())
    say("serving int8 on the int8 grid", rows_equal=same, of=B)
    need(same == B, f"int8 on the int8 grid decoded other tokens than f32 in {B - same} rows")

    # bf16 against its plain route on CPU copies, the 16 rows of a request,
    # each differing row's margin net of its prefix drift; rows 0 and 1 at
    # the whole margin as well, so that no row is held looser than at the
    # raw margin
    feats, lens = reqs[0]
    t0 = time.perf_counter()
    plain = recorded_translate(params_c, cfg, feats, lens, "cpu", **BF16_OPTS)
    plain_s = time.perf_counter() - t0
    card = recorded_translate(params, cfg, feats, lens, "cuda", **BF16_OPTS)
    margins = explain_e2e(params_c, cfg, feats, lens, card, plain, net=True, raw_rows=(0, 1))
    say("serving bf16 plain arm", device="cpu", seconds=round(plain_s, 1),
        rows_differ=len(margins), of=feats.shape[0],
        max_first_divergence_margin=max(margins, default=0.0), limit=SERVE_MARGIN)
    need(all(m <= SERVE_MARGIN for m in margins),
         f"serving bf16 rows differ beyond ties: margins {margins}")
    return runs, rec


def phase_serving_universal(uparams, uparams_c, ucfg, reqs, seed):
    """The serving decode on the universal model at B=16 (K5 per hop, K7,
    K4's select): int8 + bf16 and bf16 alone, one request each, K3 and K4
    idle; and int8 on the int8 grid decoding the f32 route's tokens."""
    from stjep_tpu_torch.bridge import params_to

    runs = []
    idle = ("K3", "K4", "K3 int8+bf16", "K4 int8+bf16", "K3 bf16", "K4 bf16")
    for label, opts, ran in (("int8+bf16", SERVE_OPTS, ("K5 int8+bf16",)),
                             ("bf16", BF16_OPTS, ("K5 bf16",))):
        _, secs, launches = translate_timed(uparams, ucfg, reqs[:1],
                                            LAS_RAN + ran + ("K7 head", "K4 select"), idle,
                                            **opts)
        say(f"serving universal {label} B=16", utt_per_s=round(B / secs[0], 3),
            request_ms=round(secs[0] * 1e3, 1), launches={k: v for k, v in launches.items() if v})
        runs.append(launches)
    snapped = params_to(snap_int8_grid(uparams_c, seed), "cuda")
    f32_out = translate_timed(snapped, ucfg, reqs[:1], LAS_RAN + ("K5",))[0][0]
    q8_out, _, launches = translate_timed(snapped, ucfg, reqs[:1], LAS_RAN + ("K5 int8",),
                                          ("K5",), weight_dtype="int8")
    runs.append(launches)
    same = int((f32_out == q8_out[0]).all(dim=1).sum())
    say("serving universal int8 on the int8 grid", rows_equal=same, of=B)
    need(same == B, f"universal int8 on the grid decoded other tokens in {B - same} rows")
    return runs


def phase_dev_eval(label, params, params_c, cfg, rng, ran):
    """forward_eval ASR_ST with reference ids (dev eval) at B=16: 3 timed
    calls on the card, then the plain arm on CPU copies. preds_asr and
    preds_st must be equal, or differ only by a tie at the first
    divergence (the plain arm's log-probs of the two choices there, read
    through forward_eval's own picked_* with each arm's tokens as refs,
    within E2E_MARGIN); picked_* within 1e-4 on the rows that agree.
    Returns the main path's launch counts."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.infer.forward import forward_eval

    feats, lens = inputs(rng, B)
    refs = {"ref_src": torch.from_numpy(rng.randint(5, cfg.enc_vocab_size, (B, cfg.max_seq_len_src))),
            "ref_tgt": torch.from_numpy(rng.randint(5, cfg.dec_vocab_size, (B, cfg.max_seq_len_tgt)))}
    for r in refs.values():
        r[:, 0] = BOS

    def run(p, dev, **kw):
        kw = {**refs, **kw}
        return forward_eval(p, cfg, "ASR_ST", acous_feats=feats, acous_lens=lens,
                            device=dev, **kw)

    zero_counts()
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_g = run(params, "cuda")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = read_counts(ran)
    out_g = {k: v.cpu() for k, v in out_g.items()}
    t0 = time.perf_counter()
    out_c = run(params_c, "cpu")
    plain_s = time.perf_counter() - t0
    need(set(out_g) == set(out_c), f"{label} keys {set(out_g)} vs {set(out_c)}")
    for k, v in out_c.items():
        need(out_g[k].shape == v.shape and bool(torch.isfinite(out_g[k].float()).all()),
             f"{label} {k}: shape {tuple(out_g[k].shape)} vs {tuple(v.shape)} or not finite")
    asr_rows, st_rows = (first_diff(out_g[k], out_c[k]) for k in ("preds_asr", "preds_st"))
    margins = []
    if any(c is not None for c in asr_rows + st_rows):
        # each arm's tokens as the refs of the plain arm: picked_* are then
        # the plain log-probs of the card's and of its own choices
        with_bos = lambda p: torch.cat([torch.full_like(p[:, :1], BOS), p], 1)
        at = {nm: run(params_c, "cpu", ref_src=with_bos(o["preds_asr"]), ref_tgt=o["preds_st"])
              for nm, o in (("card", out_g), ("own", out_c))}
        for r, (ca, cs) in enumerate(zip(asr_rows, st_rows)):
            if ca is not None:
                stage, col, key = "las", ca, "picked_asr"
            elif cs is not None:
                stage, col, key = "greedy", cs - 1, "picked_st"  # picked_st[j] scores slot j+1
            else:
                continue
            m = float(abs(at["own"][key][r, col] - at["card"][key][r, col]))
            say(f"{label} differing row", row=r, stage=stage, col=col, margin=m)
            margins.append(m)
    same = [ca is None and cs is None for ca, cs in zip(asr_rows, st_rows)]
    same_asr = [ca is None for ca in asr_rows]
    err = max(max_err(out_g["picked_asr"][same_asr], out_c["picked_asr"][same_asr]),
              max_err(out_g["picked_st"][same], out_c["picked_st"][same]))
    tol = 1e-4  # log-probs through the free-running decoders in f32, summed in another order
    say(label, transformer=cfg.transformer_type, batch=B, calls=len(secs),
        utt_per_s=round(B * len(secs) / sum(secs), 3),
        call_ms=[round(x * 1e3, 1) for x in secs], plain_cpu_s=round(plain_s, 1),
        rows_differ=len(margins), of=B, max_first_divergence_margin=max(margins, default=0.0),
        limit=E2E_MARGIN, picked_max_abs_err=err, tol=tol,
        launches={k: n for k, n in launches.items() if n})
    need(all(m <= E2E_MARGIN for m in margins),
         f"{label} rows differ beyond ties: margins {margins}")
    need(err <= tol, f"{label} picked max_abs_err {err} > {tol}")
    return launches


# the step of main() that runs, for the failure line when no phase_* function
# is on the traceback
STAGE = ["arguments"]


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    STAGE[0] = "device"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs only on a GPU")
    STAGE[0] = "imports"
    from stjep_tpu_torch import kernels
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    # 1. device
    STAGE[0] = "device"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("device", name=repr(name), nvidia_smi=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    STAGE[0] = "build"
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.lib()
    say("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name)

    STAGE[0] = "params"
    cfg = ModelConfig(**FLAGSHIP)
    gen = torch.Generator().manual_seed(args.seed)
    params_c = init_seq2seq(cfg, gen, "cpu")
    params = params_to(params_c, "cuda")
    rng = np.random.RandomState(args.seed)

    # 3. kernels vs their plain versions
    results = {"K1": phase_k1(params, cfg, rng), "K2": phase_k2(params, cfg, rng)}
    # K9 right after K2: later in the script torch.profiler recorded no
    # device event at all, so the one-launch check could not see K9's kernel
    k9_res = phase_k9(params, cfg, rng)
    # the tensor-parallel kernels, one shard of TP_N, and K3's variants
    # early for the same reason: the fused K6a-c, K7c and K3 lines check one
    # device operation a call (K3 int8+bf16 after K7's and the serving K5's
    # phases saw none in 8 profiles, PERF.md section 7)
    results.update(phase_tp_kernels(params, cfg, rng))
    results.update({"K3": phase_k3(params, cfg, rng),
                    "K3 int8+bf16": phase_k3(params, cfg, rng, True, True),
                    "K3 gather": phase_k3_gather(params, cfg, rng)})
    # K7's lines check one device operation a call too
    k7 = phase_k7(params, cfg, rng)
    results["K7 head"], results["K7 head_gather"] = k7["head"], k7["head_gather"]
    results.update({"K4": phase_k4(params, cfg, rng),
                    "K4 select": phase_k4_select(params, cfg, rng),
                    "K5": phase_k5(params, cfg, rng)})
    # the serving kernels: int8 weights, bf16 caches, both
    for quant, bf16 in VARIANTS[1:]:
        results[f"K5 {variant_label(quant, bf16)}"] = phase_k5(params, cfg, rng, quant, bf16)
    results["K4 int8+bf16"] = phase_k4(params, cfg, rng, True, True)

    # 4. the main paths, each driven with every launch count zeroed just
    # before it and read just after; the kernels line sums them
    reqs = [inputs(rng, B) for _ in range(3)]
    ucfg = ModelConfig(**{**FLAGSHIP, "transformer_type": "universal"})
    uparams_c = init_seq2seq(ucfg, torch.Generator().manual_seed(args.seed + 3), "cpu")
    uparams = params_to(uparams_c, "cuda")
    runs = [
        phase_beam_e2e("e2e", params, params_c, cfg, reqs, gen,
                       ran=("K1", "K2", "K3", "K4"), idle=("K4 select",)),
        phase_beam_e2e("e2e universal", uparams, uparams_c, ucfg, reqs, gen,
                       ran=("K1", "K2", "K5", "K7 head", "K4 select"),
                       idle=("K3", "K3 gather", "K4")),
        phase_dev_eval("dev eval", params, params_c, cfg, rng,
                       ran=("K1", "K2", "K3 gather")),
        phase_dev_eval("dev eval universal", uparams, uparams_c, ucfg, rng,
                       ran=("K1", "K2", "K5", "K7 head_gather")),
    ]
    serving_runs, serving = phase_serving(params, params_c, cfg, reqs, rng, args.seed)
    runs += serving_runs + phase_serving_universal(uparams, uparams_c, ucfg, reqs, args.seed)
    # tensor-parallel decode on one card: the beam at n = 2 and 4, dev eval at 2
    runs += phase_tp_beam(params, params_c, cfg, reqs)
    runs.append(phase_tp_dev_eval(params, cfg, rng))
    say("serving summary", nvidia_smi=repr(smi),
        **{k.replace(" ", "_").replace("=", "") + ("_ms" if k.endswith("B=1") else "_utt_per_s"):
           v["median_ms"] if k.endswith("B=1") else v["utt_per_s"]
           for k, v in serving.items()})

    # 5-7. the train path: its kernels, a parity step, the flagship step
    k8_res = phase_k8(params, cfg, rng)
    for d in ("fwd", "bwd"):
        results[f"K8 {d}"], results[f"K9 {d}"] = k8_res[d], k9_res[d]
    phase_train_parity(args.seed)
    runs.append(phase_train_e2e(args.seed, rng))
    launches = {k: sum(r.get(k, 0) for r in runs) for k in counters()}

    src, rep = "stjep_tpu_torch/csrc/", "stjep_tpu/ops/"
    sources = {"K1": ("bilstm", src + "bilstm.cu", rep + "lstm_pallas.py:206"),
               "K2": ("las_greedy", src + "las_fused.cu", rep + "las_flash.py:168"),
               "K3": ("decode_chain_step", src + "decode_chain.cu", rep + "decode_flash.py:1078"),
               "K3 gather": ("decode_chain_step gather", src + "decode_chain.cu",
                             rep + "decode_flash.py:1078"),
               "K4": ("decode_beam_step", src + "decode_fused.cu", rep + "decode_flash.py:1412"),
               "K4 select": ("beam_select", src + "decode.cu", rep + "decode_flash.py:1412"),
               "K5": ("decoder_layer_step", src + "decode_fused.cu", rep + "decode_flash.py:759"),
               "K7 head": ("decode_head", src + "decode_chain.cu", rep + "decode_flash.py:1595"),
               "K7 head_gather": ("decode_head_gather", src + "decode_chain.cu",
                                  rep + "decode_flash.py:1628"),
               "K8 fwd": ("bilstm_fwd_save", src + "bilstm.cu", rep + "lstm_pallas_bwd.py:174"),
               "K8 bwd": ("bilstm_bwd", src + "bilstm_bwd.cu", rep + "lstm_pallas_bwd.py:262"),
               "K9 fwd": ("las_tf_fwd", src + "las_fused.cu", rep + "las_tf_flash.py:263"),
               "K9 bwd": ("las_tf_bwd", src + "las_fused.cu", rep + "las_tf_flash.py:364"),
               "self_attn bf16": ("self_attn_step bf16", src + "decode_fused.cu",
                                  rep + "decode_flash.py:348"),
               "cross_attn bf16": ("cross_attn_step bf16", src + "decode_fused.cu",
                                   rep + "decode_flash.py:543"),
               "K5 int8": ("decoder_layer_step int8", src + "decode_fused.cu",
                           rep + "decode_flash.py:708"),
               "K5 bf16": ("decoder_layer_step bf16", src + "decode_fused.cu",
                           rep + "decode_flash.py:759"),
               "K5 int8+bf16": ("decoder_layer_step int8+bf16", src + "decode_fused.cu",
                                rep + "decode_flash.py:708"),
               "K3 int8+bf16": ("decode_chain_step int8+bf16", src + "decode_chain.cu",
                                rep + "decode_flash.py:1078"),
               "K4 int8+bf16": ("decode_beam_step int8+bf16", src + "decode_fused.cu",
                                rep + "decode_flash.py:1412"),
               "K6 self_attn_step": ("self_attn_step", src + "decode_fused.cu",
                                     rep + "decode_flash.py:348"),
               "K6 cross_attn_step": ("cross_attn_step", src + "decode_fused.cu",
                                      rep + "decode_flash.py:543"),
               "K6 ffn_step": ("ffn_step", src + "decode_fused.cu", rep + "decode_flash.py:622"),
               "K7 head_partial": ("decode_head_partial", src + "decode_chain.cu",
                                   rep + "decode_flash.py:1666")}
    STAGE[0] = "kernels line"
    need(all(launches[k] > 0 for k in sources), f"a kernel never launched: {launches}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "source": s_, "replaces": r_,
         "launches": launches[k], **{x: results[k][x] for x in keys}}
        for k, (nm, s_, r_) in sources.items()]}))
    say("total", seconds=round(time.perf_counter() - t_start, 1))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def failed_phase(exc: BaseException) -> str:
    """The innermost phase_* function of this script on exc's traceback, or
    the step of main() that ran."""
    here = Path(__file__).resolve()
    names = [f.name for f in traceback.extract_tb(exc.__traceback__)
             if Path(f.filename).resolve() == here and f.name.startswith("phase_")]
    return names[-1] if names else STAGE[0]


def run() -> int:
    """main(); on any failure the traceback goes to stderr and one line
    `[failed] phase=... error=...` to stdout, and the exit code is 1."""
    try:
        return main()
    except Exception as e:  # noqa: BLE001 - reported, then the exit code says so
        traceback.print_exc()
        msg = " ".join(str(e).split())[:500]
        print(f"[failed] phase={failed_phase(e)} error={type(e).__name__}: {msg}", flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(run())
