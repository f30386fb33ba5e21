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
8. train cli: the port's train CLI (`stjep_tpu_torch/cli/train.py`, train.py's
   flags) and Trainer at the flagship widths on a corpus the phase writes
   from the seed (64 train and 16 dev utterances of 400-1504 frames, a
   30 000-word source and 200-symbol target vocabulary, 40-dim fbank .npy,
   per-speaker CMVN), B = 16:
   a. ASR_ST, one epoch (4 steps) with dev eval every 2 steps, dropout
      0.2, SpecAugment, per-step staging through the native loader: the
      loop's steps/s (loader included, dev evals and checkpoint writes
      left out) beside the bare step's of phase 7, dev-eval utt/s, peak
      memory, the checkpoint written, and the launch counts (K8, K9 in
      training; K1, K2, K3 gather in dev eval);
   b. the Trainer's first step (dropout 0) against make_train_step on the
      same staged batch and init: every leaf within 1e-6 of its norm;
   c. --load_mode resume of the Trainer's checkpoint: the loaded params
      bit-equal to the saved ones, resumed at the saved step, 2 more steps;
   d. --dtype bfloat16, 4 steps: finite losses, bf16 params, and the Adam
      state dtypes of optax's init (count int32, mu/nu bf16, step_size f32);
   e. --device_cache True --feat_dtype int8 --train_window 4, 8 steps, each
      window under torch.cuda.set_sync_debug_mode("error"): steps/s and the
      cache's bytes on the card; and with dropout 0 one window within 1e-6
      of each leaf's norm of 4 single steps on the same batches.

9. translate cli: the port's translate CLI (`stjep_tpu_torch/cli/translate.py`,
   translate.py's flags) on the flagship params of phase 4 written as a
   checkpoint, on a test split the phase writes from the seed (32
   utterances of 400-1504 frames, 2 batches of B = 16, CMVN), beam 5, 150
   target positions, each run a main path with its launch counts:
   a. mode 3 (K1, K9's forward): dyn_emb_ave.npy within 1e-4 (relative)
      of the same mean on the plain route (CPU copies);
   b. mode 1 in gen modes ST, ASR, ASR-REF, ST-REF, MT (on a's
      dyn_emb_ave) and ST_BASE, and ST with --feat_dtype int8 and with
      --beam_cache_dtype bfloat16 --weight_dtype int8: the CLI's lines
      equal those of forward_translate on the same staged batches on the
      card, and batch 0's 16 rows (MT, ST-REF: rows 0-1) against the plain
      arm on CPU copies,
      every differing row a tie (E2E_MARGIN, at the first differing LAS
      symbol, teacher forced in the REF modes, or beam position; the
      serving run SERVE_MARGIN net of its prefix drift); the launches each
      mode claims (K1, K2, K3, K4 for ST; K9's forward for the REF modes);
   c. the CLI's ST utt/s against bare forward_translate on the same staged
      batches, in turns;
   d. ASR with an n-gram LM, as a pickled ARPA-style dict (the device
      table) and as an object whose logscore applies the same backoff (the
      host fuser): the same lines, but where the host's fused top-2 gap is
      below TIE; no K2 under either; an ASR pass's ms under each against K2;
   e. mode 2 over two checkpoints against their leaf-wise mean (bit-equal)
      and its ckpts.log; mode 4 (K1, K2), which without tensorboard returns
      None as JAX's does.

10. act and dense eval (its own seconds on its last line): a universal
   transformer with ACT at the flagship widths (random weights from
   init_seq2seq(seed + 5)) and the standard model of phase 4:
   a. the ACT ST beam-5 through forward_translate on 2 requests of B=16
      (K1, K2, each position a re-run of the [80, 150] token buffer in
      plain PyTorch, then K4's select kernel; K3, K4, K5 and K7 idle):
      utt/s; rows 0-1 of a request as a batch of their own on the card,
      with the halting loops' mean layer maps (encoder and decoder hops),
      and on CPU copies, every differing row a tie within E2E_MARGIN (an
      ACT decoder halts on its whole batch, so a batch is held only
      against the same batch);
   b. ACT dev eval, forward_eval("ASR_ST") with refs at B=16 (K1, K2,
      the greedy re-running its buffer): utt/s; rows 0-3 as a batch of
      their own against CPU copies as dev eval's: preds up to ties,
      picked_* within 1e-4;
   c. forward_eval("ASR_ST") without refs on the standard model at B=16
      (the LAS step loop for logps_asr, no K2; the dense greedy: K5 per
      hop and a plain head, no K3): call ms and peak memory; against CPU
      copies, preds up to ties, logps_* within 1e-4 on agreeing rows;
   d. the ASR_ST train step with cfg.remat (B=16, dropout 0.2,
      SpecAugment): loss and gradients against the step without remat
      from one generator (1e-6 of each leaf's norm), then 3 timed steps
      each way: step ms and peak memory, and the remat steps' K8/K9
      launches.

11. mesh train (its own seconds on its last line): the Trainer on a
   (data, model) mesh of the one card, several shards on it
   (parallel/mesh.py, parallel/spmd.py), at the flagship (ASR_ST, B=16,
   1504 frames, dropout 0.2, SpecAugment):
   a. one batch's losses and gradients on make_mesh(2, 2, ["cuda"] * 4)
      against the unsharded Trainer's from the same params and generator:
      the loss within 1e-5 relative, each gathered gradient leaf within
      1e-5 of its norm on the unsharded step's ReLU pieces (the mesh's FFN
      shards replay their columns of them, as phase 6 replays its arms';
      the pieces its own rounding flips must be at most RELU_FLIPS_MAX and
      ties: the two arms' FFN pre-activations within RELU_BAND of each
      call's largest; the gradients on its own pieces are printed beside); then steps in turns (2 warm-up, 5 timed each):
      step ms, and one profiled step each way: device busy ms, K8's and
      K9's sweep kernels' device ms, idle share, host aten operators, peak
      memory;
   b. K8 and K9 launches a mesh step: twice the unsharded step's (each
      data shard runs them on its half of the batch);
   c. dev eval (forward_eval ASR_ST with refs, B=16) under the (2, 2)
      mesh against the single-device card route: ASR preds equal, ST
      preds up to ties (E2E_MARGIN), picked within 1e-4; K1, K2 per data
      shard, K6a-c and K7c launched, K3 gather, K5 and K7 idle;
   d. 2 mesh steps saved, loaded into an unsharded Trainer (load_mode
      resume): params and Adam state bit-equal to the mesh's gathered
      ones; resumed on the mesh, one step bit-equal to a mesh run of 3
      steps that never stopped;
   e. the train CLI with --n_model 2 on the one card: make_mesh's
      degrade warning, a (1, 1) mesh, 4 steps bit-equal to --n_model 1;
   f. ACT dev eval (the ACT model of phase 10's seed), rows 0-1 under a
      (1, 2) mesh equal to the same rows without one.

12. multi-process train (its own seconds on its last line): two ranks of
   stjep_tpu_torch/scripts/multiproc_worker.py on the one card (gloo; NCCL
   refuses two ranks on one device), spawned after the build so they load
   its library, at the flagship (ASR_ST, B=16 split into 8 rows a rank,
   1504 frames), each rank stepping on its rows and the gradients summed
   over the ranks in one all-reduce:
   a. one step with dropout off against the one-process step on the card
      from the same params and batch: the loss within 1e-5 relative, each
      gradient leaf within 1e-5 of its norm on the one-process step's ReLU
      pieces (each rank replays its rows of them; its own rounding may
      part at most RELU_FLIPS_MAX pieces, each a tie within RELU_BAND);
   b. the same with dropout 0.2 and SpecAugment on (one generator: each
      rank's draws are its rows of the whole batch's);
   c. 3 Trainer steps: the ranks' params and Adam states bit-equal
      (digests);
   d. the Trainer's checkpoint written once, by rank 0 (its msgpack
      writes), into one dir, and each rank's load of it bit-equal to its
      params and Adam state;
   e. make_train_step with dropout, 2 warm-up and 5 timed steps: each
      rank's step ms beside the one-process step's in this run, the
      all-reduce's ms inside the step and its bytes, the backend, and each
      rank's K8/K9 launches a step (the kernels line adds them).
   A rank that fails, or runs past MP_TIMEOUT, fails the phase.

13. recipe (its own seconds on its last line): the port's end-to-end
   training scripts (stjep_tpu_torch/scripts/):
   a. full_recipe.py --dims flagship: scripts/run_full_recipe.sh's six
      stages through the port's CLIs at the flagship widths on the train
      cli phase's corpus (CORPUS_UTTS), 4 steps a training stage: ASR, mode 3,
      MT on its artifact, ASR_ST from the ASR checkpoint (--load_mode ASR),
      ST from the joint one (ALL-PARTIAL, the LAS frozen), the ST beam-5
      decode. Each stage's launch counts zeroed before it and read after
      it: K8 and K9 (forward and backward) in ASR and ASR_ST, K8 and no K9
      in ST (its LAS runs free, through the differentiable step loop, as
      JAX's XLA scan), K1 and K9's forward in mode 3, K1-K4 in the decode,
      no K8 in MT; the
      script's checks (a checkpoint a training stage, the artifact's
      shape, a line a test utterance, the LAS loaded at step 0 of ASR_ST,
      bit-equal after ST while other leaves moved); the decode's lines
      equal to forward_translate's on the same staged batches
      (`cli_staged_lines`, the translate cli phase's helper);
   b. quality_ab.py for seed 333 at 4 + 4 epochs on the quality run's
      corpus and widths: it finishes and writes its JSON; WER and BLEU
      printed, not held (the run is too short for the band); K1, K3, K3
      gather, K4 and K8 launched, and no K2 or K9 (the LAS step loop at
      these widths, JAX's gate). Its kernels held at these widths (D 32,
      head width 8, acoustic hidden 16) on the run's own inputs: the
      joint stage's first dev eval at B = 32 (K1, K3 gather) and the ST
      beam decode's first batch (K1, K3, K4) against CPU copies, rows
      equal up to ties (1e-3) and picked_* within 1e-4; K8 forward and
      backward at that dev batch's lengths against the plain version
      (1e-4 and 1e-3 relative).

14. quality kernel (its own seconds on its last line): the kernel profile
   of stjep_tpu_torch/scripts/quality.py (D 128, 4 heads, FF 256,
   acoustic hidden 64: D and 2H pass JAX's gate, so the LAS runs K9 in
   training and K2 when it runs free):
   a. quality.py --profile kernel for 2 + 2 epochs on its full corpus (360
      + 48 sentences, 24 steps a training stage): it finishes with its
      route check passed (K8, K9 forward and backward in every step of
      ASR and ASR_ST, K2 in every dev eval) and each stage's kernels
      launched (QK_RAN); WER and BLEU printed, not held (too short for
      the gate). On the run's own inputs: K9 forward and backward on the
      joint stage's first train step's LAS scan, K8 on that step's
      pyramid layers (1e-3, 1e-4 / 1e-3 relative), the joint stage's first
      dev eval (K1, K2, K3 gather) and the ST beam decode's first batch
      (K1, K2, K3, K4's select: the decoder projects its 32-wide
      embeddings to D, so the beam takes the general loop) against CPU
      copies as in 13 b;
   b. eval_audit.py's 15 cells (eval modes 1-4, the six gen modes with
      and without the n-gram LM) on a's joint checkpoint and its own
      16-sentence test set, each on the card and on the CPU: mode 1 lines
      equal, mode 2 bit-equal to the leaf-wise mean on both, mode 3 within
      1e-5 relative, mode 4's rows within 1e-5; no K2 or K9 under the LM,
      K2 (ASR, ST, ST_BASE) or K9's forward (ASR-REF, ST-REF) without it.

The last lines: a JSON object with one entry per kernel (its launches
summed over the main paths' runs), the total seconds, the nvidia-smi line,
then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

try:  # the flagship workload and the helpers the port's scripts share
    from stjep_tpu_torch.scripts.flagship import (
        B, BEAM, CORPUS_FRAMES, CORPUS_UTTS, DECODE_LEN, FLAGSHIP, FRAMES, TRAIN_LR, inputs,
        say, train_batch, train_flags, write_corpus)
    from stjep_tpu_torch.utils.profiling import VARIANTS, variant_label
except ImportError as e:  # run without the package beside it
    traceback.print_exc()
    print(f"[failed] phase=imports error={type(e).__name__}: {e}", flush=True)
    sys.exit(1)

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

PARITY_B, PARITY_FRAMES = 2, 256
# train parity: each gradient leaf's distance from float64 on the same ReLU
# pieces, relative to its norm. Both f32 arms read 1.2e-5 to 2.1e-5 over
# seeds 0-7 (stjep_tpu_torch/scripts/train_parity_seeds.py on an H100)
PARITY_TOL = 1e-4


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


def phase_tp_dev_eval(params, cfg, rng, shape=(1, 2), label="tp dev eval n=2"):
    """forward_eval("ASR_ST") with refs at B=16 on mesh `shape` (1, 2) of
    the card against the single-device card route: preds_asr equal, preds_st equal
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
    from stjep_tpu_torch.parallel.mesh import make_mesh
    from stjep_tpu_torch.parallel.spmd import set_kernel_mesh

    set_kernel_mesh(make_mesh(*shape, ["cuda"] * (shape[0] * shape[1])))
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
    say(label, mesh=list(shape), batch=B, call_ms=round(secs * 1e3, 1), rows_differ=len(margins),
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
    from stjep_tpu_torch.utils import trace_tools

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_TRIES):
        time.sleep(0.1 * attempt)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evs = trace_tools.device_ops(prof.events())
        if evs:
            break
    short = {trace_tools.short_name(e.name) for e in evs}
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


K8_TOL = {"fwd": 1e-4, "bwd": 1e-3}  # relative; phase_k8 says why


def k8_layer(p, rng, n, T, din, lens, x=None):
    """One pyramid layer (params p) through K8's forward and backward and
    their plain versions on the same tensors: inputs x [n, T, din] (from
    rng where not given) and output gradients g from rng, on the card.
    Returns (x, g, the forward's arguments, its outputs, the plain ones,
    the backward's arguments, its output, the plain one)."""
    from stjep_tpu_torch.ops import lstm_pallas_bwd as k8

    H = p["fwd"]["w_hh"].shape[0]
    w = tuple((p["fwd"][k], p["bwd"][k]) for k in ("w_ih", "w_hh"))
    bias = tuple(q["b_ih"] + q["b_hh"] for q in (p["fwd"], p["bwd"]))
    if x is None:
        x = torch.from_numpy(rng.uniform(-1, 1, (n, T, din)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(n, T, 2 * H).astype(np.float32)).cuda()
    fargs = (*w, bias, x, lens)
    plain = k8.bilstm_fwd_save_plain(*fargs)
    fwd = k8.bilstm_fwd_save(*fargs)
    bargs = (g, plain[2], plain[3], w[1], lens)
    return x, g, fargs, fwd, plain, bargs, k8.bilstm_bwd(*bargs), k8.bilstm_bwd_plain(*bargs)


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
        x, g, fargs, fwd, plain, bargs, a, b = k8_layer(p, rng, B, T, din, lens)
        for c, d in zip(fwd, plain):
            err["fwd"], rel["fwd"] = max(err["fwd"], max_err(c, d)), max(rel["fwd"], rel_err(c, d))
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
    tol = K8_TOL
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
    ids = torch.from_numpy(rng.randint(5, cfg.enc_vocab_size, (S, B))).cuda()
    p0 = dec["dec_l0"]
    pre0 = (dec["embedder"][ids] @ p0["w_ih"][:E] + p0["b_ih"] + p0["b_hh"]).contiguous()
    acous = t(rng.uniform(-1, 1, (B, Tk, Ha2)))
    lens = torch.from_numpy(rng.randint(Tk // 2, Tk + 1, size=(B,))).cuda()
    drop = (t((rng.rand(S, 3, B, Hd) < keep) / keep), t((rng.rand(S, B, 1, Ha2) < keep) / keep))
    # the kernels' arguments as las_tf_scan's Function builds them
    w, wk, masks = k9.kernel_args(acous, *k9.scan_inputs(
        dec, dec["acous_att"]["linear_att_w"]["w"], dec["acous_ffn"]["w"], drop), pack=True)
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
    from stjep_tpu_torch.scripts.multiproc_worker import relu_patterns
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
            pats[arm] = [x > 0 for x in seen]
        else:  # entries where float64's own sign differs from the replayed one
            flips[arm] = sum(int(((a > 0) != b).sum()) for a, b in zip(seen, replay))
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
    return launches, len(timed) / sum(timed)


def cli_argv(corpus, save, seed, *extra, dev=False):
    """train.py's flags for the flagship ASR_ST model (flagship.train_flags:
    bench's widths, f32, B = 16) on the corpus, with CMVN, one epoch, a
    checkpoint every 2 steps; `extra` overrides."""
    argv = ["--mode", "ASR_ST", "--save", str(save),
            "--st_train_path_src", corpus["train_src"], "--st_train_path_tgt", corpus["train_tgt"],
            "--st_train_acous_path", corpus["train_flis"], "--st_acous_norm_path", corpus["norm"],
            "--path_vocab_src", corpus["vocab_src"], "--path_vocab_tgt", corpus["vocab_tgt"],
            *train_flags(), "--num_epochs", "1",
            "--loss_nll_asr_coeff", "1.0", "--loss_nll_st_coeff", "1.0",
            "--random_seed", str(seed), "--checkpoint_every", "2"]
    if dev:
        argv += ["--st_dev_path_src", corpus["dev_src"], "--st_dev_path_tgt", corpus["dev_tgt"],
                 "--st_dev_acous_path", corpus["dev_flis"]]
    return argv + list(extra)


def loop_steps_per_s(t) -> float:
    """Train steps a second of the Trainer's epoch loops, loader and
    staging included, dev evals and checkpoint writes left out."""
    tm = t.timing
    return t.steps_run / (tm["loop_s"] - tm["eval_s"] - tm["save_s"])


def leaf_rel_errs(a_tree, b_tree):
    from stjep_tpu_torch.bridge import named_leaves

    return {n: float((a.detach().float() - b.detach().float()).norm()
                     / max(float(a.detach().float().norm()), 1e-12))
            for (n, a), (_, b) in zip(named_leaves(a_tree), named_leaves(b_tree), strict=True)}


def phase_train_cli(seed, bare_steps_per_s):
    """The port's train CLI and Trainer at the flagship on a corpus of its
    own: a. one f32 epoch with dev eval and checkpoints; b. the Trainer's
    first step against make_train_step; c. resume; d. bf16; e. the int8
    device cache with 4-step windows, each step under
    set_sync_debug_mode("error").
    Returns the launch counts of a."""
    import tempfile

    from stjep_tpu_torch.bridge import leaves, named_leaves
    from stjep_tpu_torch.cli import train as cli
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.data.dataset import Dataset
    from stjep_tpu_torch.data.loader import NativeLoader, get_native_loader
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.ops.transformer import split
    from stjep_tpu_torch.train import trainer as T
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.policies import trainable_mask

    with tempfile.TemporaryDirectory(prefix="stjep_train_cli_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        corpus = write_corpus(tmp / "corpus", seed, CORPUS_UTTS)
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        need(get_native_loader() is not None, "the native loader did not build (no g++?)")
        say("train cli corpus", train=CORPUS_UTTS["train"], dev=CORPUS_UTTS["dev"],
            frames=list(CORPUS_FRAMES), write_s=round(corpus_s, 3),
            native_loader_build_s=round(time.perf_counter() - t0, 3))

        # a. the CLI, f32, with a dev set; eval's launches apart
        in_eval = dict.fromkeys(counters(), 0)
        evaluate = T.Trainer._evaluate_batches

        def counted_eval(self, *a, **kw):
            before = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
            try:
                return evaluate(self, *a, **kw)
            finally:
                for k, (fn, attr) in counters().items():
                    in_eval[k] += getattr(fn, attr) - before[k]

        calls0 = NativeLoader.calls
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        T.Trainer._evaluate_batches = counted_eval
        try:
            t0 = time.perf_counter()
            ta, (cfg, params) = cli.main(cli_argv(corpus, tmp / "a", seed, dev=True), device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            T.Trainer._evaluate_batches = evaluate
        launches = read_counts(("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd", "K1", "K2", "K3 gather"))
        in_train = {k: launches[k] - in_eval[k] for k in launches}
        loaded = NativeLoader.calls - calls0
        ckpt_dir = tmp / "a" / "checkpoints"
        ckpts = sorted(os.listdir(ckpt_dir)) if ckpt_dir.is_dir() else []
        losses = [float(v) for v in ta._last_losses().values()]
        say("train cli a", mode="ASR_ST", steps=ta.steps_run, loop_steps_per_s=loop_steps_per_s(ta),
            bare_step_steps_per_s=bare_steps_per_s, wall_s=round(wall, 3),
            dev_eval_utt_per_s=ta.timing["eval_utts"] / ta.timing["eval_s"],
            dev_evals_s=round(ta.timing["eval_s"], 3), checkpoint_write_s=round(ta.timing["save_s"], 3),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            native_loader_batches=loaded, checkpoints=ckpts, last_losses=losses,
            launches_train={k: n for k, n in in_train.items() if n},
            launches_dev_eval={k: n for k, n in in_eval.items() if n})
        need(ta.steps_run == CORPUS_UTTS["train"] // B, f"train cli a ran {ta.steps_run} steps")
        need(all(in_train[k] > 0 for k in ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"))
             and all(in_eval[k] > 0 for k in ("K1", "K2", "K3 gather"))
             and not any(in_eval[k] for k in ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd")),
             f"train cli launches: train {in_train}, dev eval {in_eval}")
        need(loaded > 0, "the native loader loaded no batch")
        need(bool(ckpts), "train cli a wrote no checkpoint")
        need(all(np.isfinite(losses)), f"train cli a losses {losses}")

        # b. the Trainer's first step against a direct make_train_step call
        cfg0 = ModelConfig(**{**FLAGSHIP, "dropout": 0.0})
        ds = Dataset(path_src=corpus["train_src"], path_tgt=corpus["train_tgt"],
                     path_vocab_src=corpus["vocab_src"], path_vocab_tgt=corpus["vocab_tgt"],
                     acous_path=corpus["train_flis"], acous_norm_path=corpus["norm"],
                     acous_norm=True, max_seq_len_src=cfg0.max_seq_len_src,
                     max_seq_len_tgt=cfg0.max_seq_len_tgt, batch_size=B, mode="ST", seed=seed)
        ds.construct_batches(is_train=False)
        item = ds.materialise_batch(0)
        init = lambda: init_seq2seq(cfg0, torch.Generator().manual_seed(seed + 5), device="cuda")
        pa, pb = init(), init()
        tb = T.Trainer_ASR_ST(expt_dir=str(tmp / "b"), batch_size=B, learning_rate=TRAIN_LR,
                              learning_rate_init=TRAIN_LR, lr_warmup_steps=0, seed=seed,
                              loss_coeff={"nll_asr": 1.0, "nll_st": 1.0}, device_cache=False,
                              device="cuda")
        pa, opt_a, _, _ = tb.setup(pa, cfg0)
        staged = tb._stage_batch(item)
        tb._train_batch(cfg0, pa, opt_a, staged, 1)
        opt = make_optimizer(1.0, trainable_mask(pb, lambda n: False))
        step = T.make_train_step(cfg0, "ASR_ST", opt, device="cuda")
        step(pb, opt.init(pb), [{k: v[0] for k, v in staged[0].items()}],
             split(torch.Generator().manual_seed(seed))[1], TRAIN_LR)
        errs = leaf_rel_errs(pb, pa)
        worst = max(errs, key=errs.get)
        say("train cli b", trainer_vs_make_train_step_worst_leaf=worst, rel_err=errs[worst], tol=1e-6)
        need(errs[worst] <= 1e-6, f"Trainer step vs make_train_step: {worst} {errs[worst]}")
        ckpt_b = tb._save(cfg0, pa, opt_a, 1, 1, ds).path

        # c. resume the Trainer's checkpoint: 0 steps (the loaded params and
        # Adam state, held against the in-memory ones tb._save wrote), then
        # 2 more steps on half the corpus
        tc0, (_, loaded_p) = cli.main(cli_argv(corpus, tmp / "c0", seed, "--load", ckpt_b,
                                               "--load_mode", "resume", "--num_epochs", "0"),
                                      device="cuda")
        differ = {}
        for what, mine, theirs in (
                ("params", pa, loaded_p),
                ("adam", tb._tx.state_tree(pa, opt_a),
                 tc0._tx.state_tree(loaded_p, tc0._final_opt_state))):
            a, b = dict(named_leaves(mine)), dict(named_leaves(theirs))
            differ[what] = sorted(set(a) ^ set(b)) + [
                n for n in a if n in b and not (a[n].dtype == b[n].dtype
                                                and torch.equal(a[n].cpu(), b[n].cpu()))]
        n_adam = len(named_leaves(tb._tx.state_tree(pa, opt_a)))
        tc, _ = cli.main(cli_argv(corpus, tmp / "c", seed, "--load", ckpt_b, "--load_mode",
                                  "resume", "--st_data_ratio", "0.5"), device="cuda")
        say("train cli c", resumed_at=list(tc.start), saved_step=1,
            params_bit_equal_to_saved=not differ["params"],
            adam_state_bit_equal_to_saved=not differ["adam"], adam_leaves=n_adam,
            steps_after_resume=tc.steps_run,
            model_cont_cfg=(tmp / "c" / "model-cont.cfg").exists())
        need(not differ["params"], f"resumed params differ from the saved ones: {differ['params'][:5]}")
        need(not differ["adam"], f"resumed Adam state differs from the saved one: {differ['adam'][:5]}")
        need(tc0.start == (1, 1) and tc.start == (1, 1) and tc.steps_run == 2,
             f"resume: start {tc0.start}/{tc.start}, {tc.steps_run} steps")
        need((tmp / "c" / "model-cont.cfg").exists(), "resume wrote no model-cont.cfg")

        # d. bf16
        td, (_, pd) = cli.main(cli_argv(corpus, tmp / "d", seed, "--dtype", "bfloat16"),
                               device="cuda")
        tree = td._tx.state_tree(pd, td._final_opt_state)["inner_states"]["train"]["inner_state"]
        mu = [x for x in leaves(tree["1"]["mu"]) if torch.is_tensor(x)]
        dtypes = {"params": sorted({str(x.dtype) for x in leaves(pd)}),
                  "count": str(tree["1"]["count"].dtype),
                  "mu_nu": sorted({str(x.dtype) for x in mu + leaves(tree["1"]["nu"])
                                   if torch.is_tensor(x)}),
                  "step_size": str(tree["2"]["hyperparams"]["step_size"].dtype)}
        losses = [float(v) for v in td._last_losses().values()]
        say("train cli d", dtype="bfloat16", steps=td.steps_run,
            loop_steps_per_s=loop_steps_per_s(td), last_losses=losses, dtypes=dtypes)
        need(td.steps_run == 4 and all(np.isfinite(losses)) and any(losses),
             f"bf16: {td.steps_run} steps, losses {losses}")
        # optax: make_optimizer(...).init(params_bf16) keeps mu/nu in the
        # params' dtype, the counts int32 and step_size f32
        need(dtypes == {"params": ["torch.bfloat16"], "count": "torch.int32",
                        "mu_nu": ["torch.bfloat16"], "step_size": "torch.float32"},
             f"bf16 dtypes {dtypes}")

        # e. the int8 device cache with 4-step windows, no host sync in a step
        train_batch = T.Trainer._train_batch

        def strict_step(self, *a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return train_batch(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        T.Trainer._train_batch = strict_step
        try:
            te, _ = cli.main(cli_argv(corpus, tmp / "e", seed, "--device_cache", "True",
                                      "--feat_dtype", "int8", "--train_window", "4",
                                      "--num_epochs", "2", "--print_every", "4",
                                      "--checkpoint_every", "4"), device="cuda")
        finally:
            T.Trainer._train_batch = train_batch
        cache = te._feat_cache
        # the window against 4 single steps, dropout 0, on the same batches
        finals = {}
        for win in (1, 4):
            tw = T.Trainer_ASR_ST(expt_dir=str(tmp / f"w{win}"), batch_size=B,
                                  learning_rate=TRAIN_LR, learning_rate_init=TRAIN_LR,
                                  lr_warmup_steps=0, seed=seed, print_every=10 ** 9,
                                  checkpoint_every=10 ** 9,
                                  loss_coeff={"nll_asr": 1.0, "nll_st": 1.0},
                                  device_cache=True, feat_dtype="int8", train_window=win,
                                  device="cuda")
            dsw = Dataset(path_src=corpus["train_src"], path_tgt=corpus["train_tgt"],
                          path_vocab_src=corpus["vocab_src"], path_vocab_tgt=corpus["vocab_tgt"],
                          acous_path=corpus["train_flis"], acous_norm_path=corpus["norm"],
                          acous_norm=True, max_seq_len_src=cfg0.max_seq_len_src,
                          max_seq_len_tgt=cfg0.max_seq_len_tgt, batch_size=B, mode="ST",
                          seed=seed)
            _, finals[win] = tw.train({"st": dsw}, (cfg0, init()), num_epochs=1)
            need(tw.windows_run == (1 if win == 4 else 0), f"window runs {tw.windows_run}")
        errs = leaf_rel_errs(finals[1], finals[4])
        worst = max(errs, key=errs.get)
        say("train cli e", feat_dtype="int8", train_window=4, steps=te.steps_run,
            windows=te.windows_run, loop_steps_per_s=loop_steps_per_s(te),
            cache_bytes_on_card=cache.nbytes, cache_shape=list(cache.feats.shape),
            cache_device=str(cache.feats.device), sync_debug_mode="error",
            window_vs_single_steps_worst_leaf=worst, rel_err=errs[worst], tol=1e-6)
        need(te.steps_run == 8 and te.windows_run == 2 and cache.feats.is_cuda,
             f"window run: {te.steps_run} steps, {te.windows_run} windows")
        need(errs[worst] <= 1e-6, f"window vs single steps: {worst} {errs[worst]}")
    return launches


# the translate cli phase: a test split of 2 batches of B, the LM's fusion weight
TEST_UTTS = 2 * B
LM_MODE = "s-4g_0.9"


class ArpaLM:
    """An n-gram export's scores through .logscore(word, context) over
    stringified ids, with the device table's ARPA backoff recursion
    (infer/lm_table.py) in float64: the host fuser's LM that scores as the
    table does."""

    def __init__(self, export):
        self.entries, self.backoffs = export["entries"], export["backoffs"]

    def logscore(self, word, context):
        ctx, w, acc = tuple(int(x) for x in context), int(word), 0.0
        while True:
            if ctx + (w,) in self.entries:
                return acc + self.entries[ctx + (w,)]
            if not ctx:
                return float("-inf")
            acc += self.backoffs.get(ctx, 0.0)
            ctx = ctx[1:]


def lm_export(seed, V, hyps):
    """An ARPA-style export {"entries", "backoffs"} from the seed: every
    unigram of the source vocabulary, the 2- to 4-grams of `hyps` (ASR
    hypotheses [N, L], so that a fused decode meets stored contexts) and
    random ones, and backoff weights for most stored n-grams of orders 1-3."""
    rng = np.random.RandomState(seed + 13)
    entries = {(w,): float(-rng.uniform(2.0, 6.0)) for w in range(V)}
    for row in hyps.tolist():
        for n in (2, 3, 4):
            for i in range(len(row) - n + 1):
                if rng.rand() < 0.5:
                    entries[tuple(row[i:i + n])] = float(-rng.uniform(0.2, 3.0))
    for _ in range(5000):
        key = tuple(int(x) for x in rng.randint(0, V, rng.randint(2, 5)))
        entries[key] = float(-rng.uniform(0.2, 3.0))
    # backoff weights on stored n-grams only, as an ARPA file attaches them:
    # the table (JAX's) takes a key stored with a backoff alone as found, at
    # MISS_SCORE, where an ARPA reader backs off past it
    backoffs = {k: float(-rng.uniform(0.1, 1.5)) for k in entries
                if len(k) < 4 and rng.rand() < 0.7}
    return {"entries": entries, "backoffs": backoffs}


def first_rows(rec, n):
    """recorded_translate's return cut to its first n rows."""
    toks, las, states = rec
    return (toks[:n], None if las is None else las[:n],
            [(p[:n * BEAM], sc[:n * BEAM]) for p, sc in states])


def phase_translate_cli(seed, params_c, cfg):
    """The port's translate CLI (`stjep_tpu_torch/cli/translate.py`,
    translate.py's flags) at the flagship on a test split it writes from
    the seed (TEST_UTTS utterances, B = 16) and a flagship checkpoint of
    params_c; every run a main path, its launch counts zeroed before and
    read after. Mode 3 against the plain route's mean (1e-4 relative);
    mode 1 in gen modes ST (beam 5), ASR, ASR-REF, ST-REF, MT (on mode 3's
    dyn_emb_ave) and ST_BASE: the CLI's lines equal those of
    forward_translate on the same staged batches on the card, and batch
    0's rows (MT, ST-REF: rows 0-1) against the plain arm on CPU copies,
    every differing row a tie (`explain_e2e`); --feat_dtype int8 and --beam_cache_dtype bfloat16
    --weight_dtype int8 the same, the latter within SERVE_MARGIN net of the
    prefix drift; ASR with the device-table LM against the host-fuser LM
    (the same scores), no K2 under either; mode 2 against a leaf-wise
    mean; mode 4. Times the CLI's ST decode against bare forward_translate
    on the same staged batches, and an ASR pass with each LM against K2.
    Returns the runs' launch counts."""
    import dataclasses
    import pickle
    import tempfile

    from stjep_tpu_torch.bridge import named_leaves, params_to
    from stjep_tpu_torch.cli import translate as tcli
    from stjep_tpu_torch.data.dataset import Dataset
    from stjep_tpu_torch.infer import lm_fusion
    from stjep_tpu_torch.infer.lm_table import NGramTable, make_table_fuser
    from stjep_tpu_torch.train.checkpoint import Checkpoint
    from stjep_tpu_torch.train.policies import map_with_path

    runs = []
    with tempfile.TemporaryDirectory(prefix="stjep_translate_cli_") as tmp:
        tmp = Path(tmp)
        corpus = write_corpus(tmp / "corpus", seed, utts={"test": TEST_UTTS})
        vocab = [Path(corpus[k]).read_text(encoding="utf-8").splitlines()
                 for k in ("vocab_src", "vocab_tgt")]

        def save(p, where):
            t0 = time.perf_counter()
            path = Checkpoint(params=p, input_vocab=vocab[0], output_vocab=vocab[1],
                              model_config=dataclasses.asdict(cfg)).save_customise(str(tmp / where))
            return path, time.perf_counter() - t0

        ckpt, save_s = save(params_c, "ckpt")

        def cli_run(label, ran, idle, *extra, load=ckpt):
            """main() on the card with translate.py's flags; (its return,
            seconds, launches)."""
            argv = ["--test_path_src", corpus["test_src"], "--test_path_tgt", corpus["test_tgt"],
                    "--test_acous_path", corpus["test_flis"], "--acous_norm", "True",
                    "--acous_norm_path", corpus["norm"], "--load", load,
                    "--test_path_out", str(tmp / label.replace(" ", "_")),
                    "--batch_size", str(B), "--max_seq_len", str(DECODE_LEN),
                    "--beam_width", str(BEAM), *extra]
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tcli.main(argv, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_counts(ran, idle)
            runs.append(launches)
            return out, secs, launches

        # the test set as main() builds it, for the arms held against the CLI
        ds = Dataset(path_src=corpus["test_src"], path_tgt=corpus["test_tgt"],
                     vocab_src_list=vocab[0], vocab_tgt_list=vocab[1], use_type="char",
                     acous_path=corpus["test_flis"], acous_norm=True,
                     acous_norm_path=corpus["norm"], acous_max_len=6000, max_seq_len_src=900,
                     max_seq_len_tgt=900, batch_size=B, mode="ST")
        ds.construct_batches(is_train=False)
        items = [ds.materialise_batch(i) for i in range(len(ds))]
        need(len(items) == TEST_UTTS // B, f"{len(items)} test batches")
        say("translate cli corpus", test=TEST_UTTS, frames=list(CORPUS_FRAMES), batches=len(items),
            checkpoint_write_s=round(save_s, 3))

        # mode 3: the mean dynamic embedding (K1, K9's forward)
        path, secs, launches = cli_run("mode 3", ("K1", "K9 fwd"), ("K2", "K3", "K4"),
                                       "--eval_mode", "3")
        dyn = np.load(path)
        t0 = time.perf_counter()
        plain = np.load(tcli.gather_emb(ds, cfg, params_c, str(tmp / "mode3_plain"),
                                        logger_print=lambda *a: None, device="cpu"))
        rel = float(np.linalg.norm(dyn - plain) / np.linalg.norm(plain))
        say("translate cli mode 3", seconds=round(secs, 3), shape=list(dyn.shape),
            rel_err_vs_plain=rel, tol=1e-4, plain_cpu_s=round(time.perf_counter() - t0, 1),
            launches={k: v for k, v in launches.items() if v})
        need(dyn.shape == (cfg.dim_model,) and bool(np.isfinite(dyn).all()) and rel <= 1e-4,
             f"mode 3: shape {dyn.shape}, rel err {rel}")

        # mode 1 on a checkpoint that carries mode 3's dyn_emb_ave (MT and
        # ST_BASE read it)
        pc = {**params_c, "emb_dyn_ave": torch.from_numpy(dyn)}
        pg = params_to(pc, "cuda")
        ckpt_dyn, _ = save(pc, "ckpt_dyn")
        cfg150 = dataclasses.replace(cfg, max_seq_len_src=150)  # the CLI's LAS length

        def held(label, gen, ran, idle, *extra, feat="float32", net=False, rows=B, **opts):
            """The CLI in gen mode `gen` against forward_translate on the
            same staged batches on the card (lines equal), and batch 0's
            first `rows` rows against the plain arm on CPU copies of them
            (ties only; each row decodes alone)."""
            mode, _, hist = gen.partition("-")
            refen = hist == "REF"
            c = cfg150 if ("ASR" in mode or "ST" in mode) else cfg
            path, secs, launches = cli_run(label, ran, idle, "--eval_mode", "1", "--gen_mode",
                                           gen, *extra, load=ckpt_dyn)
            lines = Path(path).read_text(encoding="utf8").splitlines()
            cache = opts.get("cache_dtype")
            first = tcli.unstage(**tcli.stage(items[0], 0, B, mode, refen, feat, cache, "cuda"))
            card = recorded_translate(pg, c, first.get("acous_feats"),
                                      first.get("acous_lens"), "cuda", mode=mode,
                                      src=first.get("src"), refen=refen, **opts)
            want = cli_staged_lines(pg, c, ds, items, mode, refen, feat, cache, first=card[0],
                                    **opts)
            need(lines == want, f"{label}: the CLI's lines differ from forward_translate's "
                 f"on the same staged batches ({sum(a != b for a, b in zip(lines, want))} rows)")
            x = {k: v.cpu() for k, v in tcli.unstage(**tcli.stage(
                items[0], 0, rows, mode, refen, feat, cache, "cpu")).items()}
            t0 = time.perf_counter()
            plain = recorded_translate(pc, c, x.get("acous_feats"), x.get("acous_lens"), "cpu",
                                       mode=mode, src=x.get("src"), refen=refen, **opts)
            plain_s = time.perf_counter() - t0
            margins = explain_e2e(pc, c, x.get("acous_feats"), x.get("acous_lens"),
                                  first_rows(card, rows), plain, net=net,
                                  raw_rows=(0, 1) if net else (),
                                  src=x.get("src") if refen else None)
            limit = SERVE_MARGIN if net else E2E_MARGIN
            say(f"translate cli {label}", gen_mode=gen, rows=len(lines), seconds=round(secs, 3),
                utt_per_s_with_load=round(len(lines) / secs, 3), nonempty_rows=sum(map(bool, lines)),
                plain_rows=rows, plain_cpu_s=round(plain_s, 1), rows_differ=len(margins),
                max_first_divergence_margin=max(margins, default=0.0), limit=limit,
                launches={k: v for k, v in launches.items() if v})
            need(len(lines) == TEST_UTTS, f"{label}: {len(lines)} lines")
            need(all(m <= limit for m in margins), f"{label} rows differ beyond ties: {margins}")
            return card

        held("ST", "ST", LAS_RAN + ("K3", "K4"), ("K9 fwd", "K5"))
        asr = held("ASR", "ASR", LAS_RAN, ("K3", "K4", "K9 fwd"))
        held("ASR-REF", "ASR-REF", ("K1", "K9 fwd"), ("K2", "K3", "K4"))
        # the refen and MT memories span the source's 899 slots, and the
        # plain beam's cross-attention gathers them for every beam row each
        # step (~10 s a row on the card's host): rows 0-1
        held("ST-REF", "ST-REF", ("K1", "K9 fwd", "K3", "K4"), ("K2",), rows=2)
        held("MT", "MT", ("K3", "K4"), ("K1", "K2", "K9 fwd"), rows=2)
        held("ST_BASE", "ST_BASE", LAS_RAN + ("K3", "K4"), ("K9 fwd",))
        held("ST int8 features", "ST", LAS_RAN + ("K3", "K4"), ("K9 fwd",),
             "--feat_dtype", "int8", feat="int8")
        held("ST serving", "ST", LAS_RAN + ("K3 int8+bf16", "K4 int8+bf16"), ("K3", "K4"),
             "--beam_cache_dtype", "bfloat16", "--weight_dtype", "int8", feat="bfloat16",
             net=True, **SERVE_OPTS)

        # the CLI's ST decode against bare forward_translate on the same
        # staged batches, in turns (kernels built and warm)
        staged = [tcli.stage(it, 0, B, "ST", False, "float32", None, "cuda") for it in items]
        rates = {"cli": [], "bare": []}
        for way in ("cli", "bare", "cli", "bare"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if way == "cli":
                tcli.translate(ds, cfg, pg, str(tmp / "timed"), DECODE_LEN, BEAM, gen_mode="ST",
                               logger_print=lambda *a: None, device="cuda")
            else:
                for kw in staged:
                    u = tcli.unstage(**kw)
                    forward_translate_in(pg, cfg150, "ST", u["acous_feats"], u["acous_lens"], "cuda")
            torch.cuda.synchronize()
            rates[way].append(TEST_UTTS / (time.perf_counter() - t0))
        say("translate cli ST rate", cli_utt_per_s=rates["cli"], bare_utt_per_s=rates["bare"],
            of_bare=[a / b for a, b in zip(rates["cli"], rates["bare"])])

        # LM fusion: the device table and the host fuser on the same scores
        export = lm_export(seed, cfg.enc_vocab_size, asr[0])
        for nm, obj in (("table", export), ("host", ArpaLM(export))):
            with open(tmp / f"lm_{nm}.pkl", "wb") as f:
                pickle.dump(obj, f)
        gaps = []
        make_host = lm_fusion.make_ngram_fuser

        def host_fuser(lm_model, lm_mode):
            """The host fuser, recording each step's top-2 gap of its fused rows."""
            fuse = make_host(lm_model, lm_mode)

            def recording(logp, ctx, step):
                out = fuse(logp, ctx, step)
                top2 = np.sort(out, axis=1)[:, -2:]
                gaps.append(top2[:, 1] - top2[:, 0])
                return out
            return recording

        lm_lines = {}
        for nm in ("table", "host"):
            if nm == "host":
                lm_fusion.make_ngram_fuser = host_fuser
            try:
                path, secs, launches = cli_run(f"ASR lm {nm}", ("K1",), ("K2", "K9 fwd"),
                                               "--eval_mode", "1", "--gen_mode", "ASR",
                                               "--lm_mode", LM_MODE,
                                               "--lm_path", str(tmp / f"lm_{nm}.pkl"))
            finally:
                lm_fusion.make_ngram_fuser = make_host
            lm_lines[nm] = Path(path).read_text(encoding="utf8").splitlines()
            say(f"translate cli ASR lm {nm}", seconds=round(secs, 3),
                launches={k: v for k, v in launches.items() if v})
        unfused = tcli.hyp_lines(asr[0].numpy(), ds, "ASR")
        # lines that differ between the two fusers: each at a host step
        # whose fused top-2 gap is below TIE (the table rounds in f32)
        n_steps = cfg150.max_seq_len_src - 1
        g = np.stack(gaps).reshape(len(items), n_steps, B)  # [batch, step, row]
        differ = [i for i, (a, b) in enumerate(zip(lm_lines["table"], lm_lines["host"])) if a != b]
        min_gap = {i: float(g[i // B, :, i % B].min()) for i in differ}
        say("translate cli lm table vs host", lm_mode=LM_MODE, entries=len(export["entries"]),
            backoffs=len(export["backoffs"]), rows_differ=len(differ), min_gap_there=min_gap,
            tie=TIE, rows_changed_by_the_lm=sum(a != b for a, b in zip(lm_lines["host"], unfused)))
        need(all(v <= TIE for v in min_gap.values()), f"table vs host LM rows differ: {min_gap}")
        need(lm_lines["host"][:B] != unfused, "the LM changed no ASR hypothesis")

        # an ASR pass under each LM against K2, on batch 0
        x = tcli.unstage(**tcli.stage(items[0], 0, B, "ASR", False, "float32", None, "cuda"))
        table = NGramTable.from_ngrams(export["entries"], export["backoffs"], device="cuda")
        fusers = {"k2": None, "table": make_table_fuser(table, LM_MODE),
                  "host": make_host(ArpaLM(export), LM_MODE)}
        pass_ms = {}
        for nm, fuse in fusers.items():
            call = lambda: forward_translate_in(pg, cfg150, "ASR", x["acous_feats"],
                                                x["acous_lens"], "cuda", lm_fuse=fuse)
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            pass_ms[nm] = (time.perf_counter() - t0) * 1e3
        say("translate cli ASR pass", batch=B, steps=n_steps, ms=pass_ms,
            table_over_k2=pass_ms["table"] / pass_ms["k2"],
            host_over_k2=pass_ms["host"] / pass_ms["k2"])

        # mode 2: two checkpoints averaged, against a leaf-wise mean
        rng = np.random.RandomState(seed + 17)
        pb = map_with_path(pc, lambda _, t: t + 0.01 * torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32)))
        save(pc, "ckpts/a")
        save(pb, "ckpts/b")
        t0 = time.perf_counter()
        saved = tcli.main(["--test_path_src", corpus["test_src"], "--test_acous_path",
                           corpus["test_flis"], "--load", ckpt, "--test_path_out",
                           str(tmp / "m2"), "--eval_mode", "2", "--combine_path",
                           str(tmp / "ckpts")], device="cuda")
        secs = time.perf_counter() - t0
        got = Checkpoint.load(saved, params_template=pc).params
        bad = [n for (n, a), (_, b), (_, g_) in zip(named_leaves(pc), named_leaves(pb),
                                                    named_leaves(got), strict=True)
               if not torch.equal(((a.double() + b.double()) / 2).to(a.dtype), g_)]
        log = (tmp / "ckpts-combine" / "ckpts.log").read_text()
        say("translate cli mode 2", seconds=round(secs, 3), leaves=len(named_leaves(got)),
            leaves_not_the_mean=len(bad), ckpts_log=repr(log))
        need(not bad and log == "a\nb\n", f"mode 2: {bad[:5]}, log {log!r}")

        # mode 4: the projector dump (K1, K2), skipped without tensorboard
        out, secs, launches = cli_run("mode 4", (), ("K9 fwd", "K3", "K4"), "--eval_mode", "4")
        wrote = out is not None and any(Path(out).rglob("events.out.tfevents*"))
        say("translate cli mode 4", seconds=round(secs, 3), tensorboard=out is not None,
            wrote=wrote, launches={k: v for k, v in launches.items() if v})
        need(out is None or (wrote and all(launches[k] for k in LAS_RAN)),
             f"mode 4 returned {out}, launches {launches}")
    return runs


def cli_staged_lines(params, cfg, ds, items, mode, refen=False, feat="float32", cache=None,
                     first=None, **opts):
    """translate.txt's lines that forward_translate (beam BEAM, DECODE_LEN
    positions) gives on the card for the materialised batches `items` of
    the test set `ds`, each staged as the translate CLI's mode 1 stages it
    (`stage`, `unstage`); `first`: batch 0's tokens where already decoded."""
    from stjep_tpu_torch.cli import translate as tcli

    toks = [] if first is None else [first]
    for it in items[len(toks):]:
        kw = tcli.unstage(**tcli.stage(it, 0, B, mode, refen, feat, cache, "cuda"))
        toks.append(forward_translate_in(params, cfg, mode, kw.get("acous_feats"),
                                         kw.get("acous_lens"), "cuda", src=kw.get("src"),
                                         refen=refen, **opts).cpu())
    return sum((tcli.hyp_lines(t.numpy(), ds, mode) for t in toks), [])


def recorded_translate(params, cfg, feats, lens, device, step=None, mode="ST", **opts):
    """forward_translate beam-5 in `mode` on `device` (opts: its other
    arguments, e.g. max_seq_len, src, refen, the serving options) that also records the
    LAS pass's symbols and, at every beam position, the state handed on
    (tokens [BK, L] and kept scores [BK], on the host), starting with the
    state after position 1: the megastep's output for the standard decoder,
    the general loop's select for the universal one; `step` names the hooked
    function where the route is not the model's own (the general loop's
    "beam_select" under tensor parallelism). Returns (tokens [B, L] (ASR:
    the LAS symbols), the LAS symbols (None for MT), states)."""
    import stjep_tpu_torch.infer.beam as beam_mod
    import stjep_tpu_torch.infer.forward as fwd_mod

    # the function that hands the state on, and where its input preds and
    # kept scores sit among its arguments
    step = step or ("decode_beam_step_flash" if cfg.transformer_type == "standard"
                    else "beam_select")
    name, i_preds, i_scores = (step, 7, 11) if step == "decode_beam_step_flash" else (step, 5, 2)
    step, las_pass, states, las = getattr(beam_mod, name), fwd_mod._las_pass, [], []

    def recording(*a):
        if not states:  # the state after position 1: the first step's input
            states.append((a[i_preds].cpu(), a[i_scores].cpu()))
        out = step(*a)
        states.append((out[0].cpu(), out[4].cpu()))
        return out

    def recording_las(*a, **kw):
        out = las_pass(*a, **kw)
        las.append(out[1].cpu())
        return out

    setattr(beam_mod, name, recording)
    fwd_mod._las_pass = recording_las
    try:
        toks = forward_translate_in(params, cfg, mode, feats, lens, device, **opts)
    finally:
        setattr(beam_mod, name, step)
        fwd_mod._las_pass = las_pass
    return toks.cpu(), (las[0] if las else None), states


def forward_translate_in(params, cfg, mode, feats, lens, device, max_seq_len=DECODE_LEN,
                         **opts):
    """forward_translate beam-5 in `mode`, max_seq_len positions, on `device`."""
    from stjep_tpu_torch.infer.forward import forward_translate

    return forward_translate(params, cfg, mode, acous_feats=feats, acous_lens=lens,
                             beam_width=BEAM, penalty_factor=1.0, max_seq_len=max_seq_len,
                             device=device, **opts)


def las_log_probs(params_c, cfg, feats, lens, hyps, src=None):
    """The plain arm's LAS log-probs of `hyps` [B, L-1] at each step, on
    CPU copies: teacher forced on src (every step's state is the
    reference's), else free running on its own symbols."""
    from stjep_tpu_torch.config import BOS
    from stjep_tpu_torch.models.las_encoder import las_encoder_forward
    from stjep_tpu_torch.models.seq2seq import _encoder_acous
    from stjep_tpu_torch.ops.attention import precompute_keys
    from stjep_tpu_torch.ops.las_flash import las_greedy_plain
    from stjep_tpu_torch.ops.masks import round_up8

    feats, lens = feats.cpu(), lens.cpu()
    if src is not None:
        return _encoder_acous(params_c, cfg, feats, lens, tgt=src.cpu(), teacher_forcing=True,
                              ref_tokens=hyps)[1]
    dec = params_c["las"]["decoder"]
    acous, _ = las_encoder_forward(params_c["las"]["encoder"], cfg, feats, lens)
    return las_greedy_plain(dec, cfg, precompute_keys(dec["acous_att"], acous, "bilinear")["wk"],
                            acous, round_up8(lens) // 8, torch.full((feats.shape[0],), BOS),
                            cfg.max_seq_len_src - 1, ref_tokens=hyps)[2]


def explain_e2e(params_c, cfg, feats, lens, card, plain, net=False, raw_rows=(), src=None):
    """Every row where the card's tokens differ from the plain arm's must be
    explained by a tie at the first divergence, in the plain arm's own
    log-probs: if the LAS symbols differ, the plain LAS log-probs of the
    two symbols at their first difference (teacher forced on src where the
    pass was, `las_log_probs`); else, at the first beam position where the
    row's K hypotheses differ, the two arms' kept beam scores (sums of
    log-probs), sorted, within E2E_MARGIN; with net (bf16 caches, which
    drift ~3e-3 a position between two routes) that gap less the row's
    drift at the position before (`net_divergence`), except on the rows in
    raw_rows, held at the whole gap. card and plain are recorded_translate's
    returns (ASR: tokens = LAS symbols, no states; MT: no LAS symbols).
    Returns the margins."""
    (toks_c, hyp_c, st_c), (toks_p, hyp_p, st_p) = card, plain
    las_rows = first_diff(hyp_c, hyp_p) if hyp_c is not None else [None] * toks_c.shape[0]
    at = {}
    margins = []
    for r, c in enumerate(first_diff(toks_c, toks_p)):
        if c is None:
            continue
        h = las_rows[r]
        drift = 0.0
        if h is not None:
            if not at:
                at = {k: las_log_probs(params_c, cfg, feats, lens, hyp, src)
                      for k, hyp in (("card", hyp_c), ("own", hyp_p))}
            stage, pos, m = "las", h, float(abs(at["own"][r, h] - at["card"][r, h]))
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
    from stjep_tpu_torch.utils.profiling import launch_counters

    return launch_counters()


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


def phase_dev_eval(label, params, params_c, cfg, rng, ran, idle=(), rows=B):
    """forward_eval ASR_ST with reference ids (dev eval) at B=16: 3 timed
    calls on the card, then the plain arm on CPU copies. preds_asr and
    preds_st must be equal, or differ only by a tie at the first
    divergence (the plain arm's log-probs of the two choices there, read
    through forward_eval's own picked_* with each arm's tokens as refs,
    within E2E_MARGIN); picked_* within 1e-4 on the rows that agree.
    With rows < B both arms run the first `rows` rows as a batch of their
    own (an ACT decoder halts on the whole batch's positions, so the card
    holds a batch only against the same batch). Returns the main path's
    launch counts."""
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
    launches = read_counts(ran, idle)
    if rows < B:
        feats, lens = feats[:rows], lens[:rows]
        refs = {k: r[:rows] for k, r in refs.items()}
        out_g = run(params, "cuda")
    out_g = {k: v.cpu() for k, v in out_g.items()}
    margins, err, plain_s = hold_eval(label, run, out_g, params_c)
    say(label, transformer=cfg.transformer_type, batch=B, calls=len(secs),
        utt_per_s=round(B * len(secs) / sum(secs), 3),
        call_ms=[round(x * 1e3, 1) for x in secs], plain_cpu_s=round(plain_s, 1),
        rows_differ=len(margins), of=rows, max_first_divergence_margin=max(margins, default=0.0),
        limit=E2E_MARGIN, picked_max_abs_err=err, tol=EVAL_TOL,
        launches={k: n for k, n in launches.items() if n})
    need_eval_held(label, margins, err)
    return launches


EVAL_TOL = 1e-4  # log-probs through the free-running decoders in f32, summed in another order


def hold_eval(label, run, out_g, params_c):
    """forward_eval's card outputs out_g (on the host) against the plain arm
    on CPU copies; run(params, device, **kw) calls forward_eval on the same
    inputs, kw overriding its refs. preds_asr and preds_st must be equal,
    or differ only by a tie at the first divergence (the plain arm's
    log-probs of the two choices there, read through forward_eval's own
    picked_* with each arm's tokens as refs); picked_* are compared on the
    rows that agree. Returns (margins of the differing rows, picked_* max
    abs error, the plain arm's seconds); need_eval_held holds them."""
    from stjep_tpu_torch.config import BOS

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
    return margins, err, plain_s


def need_eval_held(label, margins, err):
    need(all(m <= E2E_MARGIN for m in margins),
         f"{label} rows differ beyond ties: margins {margins}")
    need(err <= EVAL_TOL, f"{label} picked max_abs_err {err} > {EVAL_TOL}")


ACT_ROWS = 2  # the ACT beam's plain arm: rows 0-1 of a request, as a batch of their own
ACT_EVAL_ROWS = 4  # the ACT dev eval's plain arm likewise
# what the ACT and dense routes must leave idle: no KV-cached step and no
# fused head (JAX's dense head is plain XLA)
DENSE_IDLE = ("K3", "K3 gather", "K4", "K5", "K7 head", "K7 head_gather")


def act_hops(run):
    """run() with the ACT halting loops recorded: (its result, {"encoder":
    [...], "decoder": [...]} the mean layer map of each call)."""
    from stjep_tpu_torch.models import tf_decoder, tf_encoder

    maps = {"encoder": [], "decoder": []}
    real = {"encoder": tf_encoder.act_enc_apply, "decoder": tf_decoder.act_dec_apply}

    def recording(side):
        def f(*a, **kw):
            out, lmap = real[side](*a, **kw)
            maps[side].append(float(lmap.float().mean()))
            return out, lmap
        return f

    tf_encoder.act_enc_apply, tf_decoder.act_dec_apply = recording("encoder"), recording("decoder")
    try:
        return run(), maps
    finally:
        tf_encoder.act_enc_apply, tf_decoder.act_dec_apply = real["encoder"], real["decoder"]


def phase_act_beam(aparams, aparams_c, acfg, reqs):
    """(a) the ACT ST beam-5 through forward_translate on 2 requests of
    B=16 (K1, K2, then each position a re-run of the [80, 150] token buffer
    in plain PyTorch and K4's select kernel); then rows 0-1 of request 0
    as a batch of their own on the card (its halting loops recorded: the
    mean layer maps) and on CPU copies, every differing row a tie within
    E2E_MARGIN. Returns the timed requests' launch counts."""
    outs, secs, launches = translate_timed(aparams, acfg, reqs[:2],
                                           LAS_RAN + ("K4 select",), DENSE_IDLE)
    feats, lens = reqs[0][0][:ACT_ROWS], reqs[0][1][:ACT_ROWS]
    t0 = time.perf_counter()
    plain = recorded_translate(aparams_c, acfg, feats, lens, "cpu")
    plain_s = time.perf_counter() - t0
    card, maps = act_hops(lambda: recorded_translate(aparams, acfg, feats, lens, "cuda"))
    margins = explain_e2e(aparams_c, acfg, feats, lens, card, plain)
    mean = lambda xs: sum(xs) / len(xs)
    say("act beam", transformer="universal+act", requests=len(secs), batch=B,
        utt_per_s=round(B * len(secs) / sum(secs), 3),
        request_ms=[round(x * 1e3, 1) for x in secs],
        encoder_mean_hops=round(mean(maps["encoder"]), 4),
        decoder_mean_hops=round(mean(maps["decoder"]), 4),
        decoder_reruns=len(maps["decoder"]), plain_rows=ACT_ROWS,
        plain_cpu_s=round(plain_s, 1), rows_differ=len(margins),
        max_first_divergence_margin=max(margins, default=0.0), limit=E2E_MARGIN,
        launches={k: n for k, n in launches.items() if n})
    need(all(m <= E2E_MARGIN for m in margins),
         f"act beam rows differ beyond ties: margins {margins}")
    return launches


def phase_dense_eval(params, params_c, cfg, rng):
    """(c) forward_eval ASR_ST without reference ids on the standard model
    at B=16: the LAS step loop for logps_asr (no K2), the dense greedy (K5
    per hop and a plain head, no K3); one warm call, one timed with its
    peak memory; then CPU copies: preds equal or parted by a tie (the
    plain arm's own log-probs of the two choices at the first divergence,
    within E2E_MARGIN), logps_* within 1e-4 on the rows that agree."""
    from stjep_tpu_torch.infer.forward import forward_eval

    feats, lens = inputs(rng, B)
    run = lambda p, dev: forward_eval(p, cfg, "ASR_ST", acous_feats=feats, acous_lens=lens,
                                      device=dev)
    run(params, "cuda")
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out_g = run(params, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts(("K1", "K5"), ("K2",) + tuple(k for k in DENSE_IDLE if k != "K5"))
    out_g = {k: v.cpu() for k, v in out_g.items()}
    t0 = time.perf_counter()
    out_c = run(params_c, "cpu")
    plain_s = time.perf_counter() - t0
    need(set(out_g) == set(out_c) >= {"logps_asr", "logps_st"},
         f"dense eval keys {set(out_g)} vs {set(out_c)}")
    for k, v in out_c.items():
        need(out_g[k].shape == v.shape and bool(torch.isfinite(out_g[k].float()).all()),
             f"dense eval {k}: shape {tuple(out_g[k].shape)} vs {tuple(v.shape)} or not finite")
    margins, same_asr, same = [], [], []
    for r, (ca, cs) in enumerate(zip(first_diff(out_g["preds_asr"], out_c["preds_asr"]),
                                     first_diff(out_g["preds_st"], out_c["preds_st"]))):
        same_asr.append(ca is None)
        same.append(ca is None and cs is None)
        if ca is None and cs is None:
            continue
        # LAS step c holds logps_asr[:, c]; the greedy's slot c logps_st[:, c]
        key, c, pk = ("logps_asr", ca, "preds_asr") if ca is not None else ("logps_st", cs,
                                                                           "preds_st")
        lp = out_c[key][r, c]
        m = float(abs(lp[out_g[pk][r, c]] - lp[out_c[pk][r, c]]))
        say("dense eval differing row", row=r, stage=key[6:], col=c, margin=m)
        margins.append(m)
    err = max(max_err(out_g["logps_asr"][same_asr], out_c["logps_asr"][same_asr]),
              max_err(out_g["logps_st"][same], out_c["logps_st"][same]))
    tol = 1e-4
    say("dense eval", transformer=cfg.transformer_type, batch=B, refs=False,
        utt_per_s=round(B / secs, 3), call_ms=round(secs * 1e3, 1),
        peak_mem_gib=peak / 2 ** 30, peak_over_resident_gib=(peak - base) / 2 ** 30,
        plain_cpu_s=round(plain_s, 1), rows_differ=len(margins), of=B,
        max_first_divergence_margin=max(margins, default=0.0), limit=E2E_MARGIN,
        logps_max_abs_err=err, tol=tol, launches={k: n for k, n in launches.items() if n})
    need(all(m <= E2E_MARGIN for m in margins),
         f"dense eval rows differ beyond ties: margins {margins}")
    need(err <= tol, f"dense eval logps max_abs_err {err} > {tol}")
    return launches


def phase_remat_step(seed, rng):
    """(d) the ASR_ST train step with cfg.remat at the flagship (B=16,
    dropout 0.2, SpecAugment): loss and every gradient leaf against the
    step without remat from the same generator (within 1e-6 of the leaf's
    norm), then make_train_step both ways on copies of one init, one
    warm-up and 3 timed steps each: step ms and peak memory. Returns the
    remat steps' launch counts."""
    from stjep_tpu_torch.bridge import named_leaves, params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.trainer import compute_grads, make_train_step

    cfgs = {"remat": ModelConfig(**FLAGSHIP, remat=True), "plain": ModelConfig(**FLAGSHIP)}
    init = init_seq2seq(cfgs["plain"], torch.Generator().manual_seed(seed + 7), "cpu")
    mb = {k: v.cuda() for k, v in train_batch(rng, cfgs["plain"], B, FRAMES).items()}
    got = {}
    for k, c in cfgs.items():
        p = params_to(init, "cuda")
        losses, grads = compute_grads(c, "ASR_ST", p, [mb], torch.Generator().manual_seed(seed))
        got[k] = (float(sum(losses.values())), [g.detach() for g in grads])
        del p
    names = [n for n, _ in named_leaves(init)]
    worst, worst_leaf = 0.0, None
    for n, a, b in zip(names, got["remat"][1], got["plain"][1]):
        rel = float((a - b).abs().max()) / max(float(b.norm()), 1e-30)
        if rel > worst:
            worst, worst_leaf = rel, n
    timing, launches = {}, None
    for k, c in cfgs.items():
        p = params_to(init, "cuda")
        opt = make_optimizer(1.0)
        state = opt.init(p)
        step = make_train_step(c, "ASR_ST", opt, device="cuda")
        gen = torch.Generator().manual_seed(seed)
        p, state, _ = step(p, state, [mb], gen, TRAIN_LR)
        torch.cuda.synchronize()
        if k == "remat":
            zero_counts()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            p, state, ls = step(p, state, [mb], gen, TRAIN_LR)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        timing[k] = ([round(x * 1e3, 3) for x in secs], torch.cuda.max_memory_allocated() / 2 ** 30)
        if k == "remat":
            launches = read_counts(("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"))
        del p, state
    say("remat step", mode="ASR_ST", B=B, frames=FRAMES, dropout=cfgs["remat"].dropout,
        loss_remat=got["remat"][0], loss_plain=got["plain"][0],
        grad_max_rel_err=worst, worst_leaf=worst_leaf, tol=1e-6,
        remat_step_ms=timing["remat"][0], plain_step_ms=timing["plain"][0],
        remat_peak_mem_gib=timing["remat"][1], plain_peak_mem_gib=timing["plain"][1],
        launches={k: n for k, n in launches.items() if n})
    need(abs(got["remat"][0] - got["plain"][0]) <= 1e-6 * max(1.0, abs(got["plain"][0])),
         f"remat loss {got['remat'][0]} vs {got['plain'][0]}")
    need(worst <= 1e-6, f"remat gradient {worst_leaf} off by {worst} of its norm")
    return launches


def phase_act_dense(seed, rng, params, params_c, cfg, reqs):
    """ACT decode and dev eval, the dense eval route and the remat step
    ((a)-(d) above), the ACT model universal + act at the flagship widths
    from init_seq2seq(seed + 5). Returns the main paths' launch counts."""
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq

    t0 = time.perf_counter()
    acfg = ModelConfig(**{**FLAGSHIP, "transformer_type": "universal", "act": True})
    aparams_c = init_seq2seq(acfg, torch.Generator().manual_seed(seed + 5), "cpu")
    aparams = params_to(aparams_c, "cuda")
    runs = [phase_act_beam(aparams, aparams_c, acfg, reqs),
            phase_dev_eval("act dev eval", aparams, aparams_c, acfg, rng, LAS_RAN,
                           DENSE_IDLE, rows=ACT_EVAL_ROWS),
            phase_dense_eval(params, params_c, cfg, rng),
            phase_remat_step(seed, rng)]
    say("act and dense eval", seconds=round(time.perf_counter() - t0, 1))
    return runs


MESH = (2, 2)  # the mesh train phase's (data, model) shape, every shard on the card
# (a)'s ReLU ties: at most this many pieces may part the mesh step from the
# unsharded one, and the arms' FFN pre-activations may differ by at most
# this share of a call's largest (f32 rounding through the layers' joins)
RELU_FLIPS_MAX, RELU_BAND = 32, 1e-4


def step_profile(fn) -> dict:
    """One call of fn (warmed up before) under torch.profiler: its wall ms
    under the profiler, the device's busy ms (the union of its kernels'
    intervals), the device ms of K8's and K9's sweep kernels, the idle
    share, and the host aten operators."""
    from stjep_tpu_torch.utils import trace_tools

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = prof.events()
    r = trace_tools.profile_reading(evs, wall)
    sweeps = sum(e.time_range.elapsed_us() for e in trace_tools.device_ops(evs) if any(
        k in e.name for k in ("bilstm_kernel", "bilstm_bwd_kernel", "tf_fwd_kernel",
                              "tf_bwd_kernel"))) / 1e3
    return {"profiled_ms": round(wall, 3), "busy_ms": round(r["busy_ms"], 3),
            "k8_k9_sweeps_ms": round(sweeps, 3),
            "idle_share": None if r["idle_share"] is None else round(r["idle_share"], 4),
            "host_aten_ops": r["host_aten_ops"]}


def phase_mesh_train(seed, rng, params, cfg):
    """(a)-(f) of phase 11. Returns the main paths' launch counts."""
    import logging
    import tempfile

    from stjep_tpu_torch.bridge import named_leaves, params_to
    from stjep_tpu_torch.cli import train as cli
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.infer.forward import forward_eval
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.parallel.mesh import gather_params, make_mesh
    from stjep_tpu_torch.parallel.spmd import kernel_mesh, set_kernel_mesh
    from stjep_tpu_torch.scripts.multiproc_worker import relu_patterns
    from stjep_tpu_torch.train import trainer as T

    t_start = time.perf_counter()
    mesh_devs = ["cuda"] * (MESH[0] * MESH[1])
    init_c = init_seq2seq(cfg, torch.Generator().manual_seed(seed + 9), "cpu")
    items = []
    for _ in range(3):
        tb = train_batch(rng, cfg, B, FRAMES)
        items.append({k: v.numpy().astype(np.int32) if k != "acous_feat" else v.numpy()
                      for k, v in tb.items()})
    runs = []
    with tempfile.TemporaryDirectory(prefix="stjep_mesh_") as tmp:
        tmp = Path(tmp)

        def trainer(tag, mesh, **kw):
            t = T.Trainer_ASR_ST(expt_dir=str(tmp / tag), batch_size=B, learning_rate=TRAIN_LR,
                                 learning_rate_init=TRAIN_LR, lr_warmup_steps=0, seed=seed,
                                 loss_coeff={"nll_asr": 1.0, "nll_st": 1.0}, device_cache=False,
                                 n_model=MESH[1] if mesh else 1,
                                 devices=mesh_devs if mesh else None, device="cuda", **kw)
            p, opt, _, _ = t.setup(params_to(init_c, "cuda"), cfg)
            set_kernel_mesh(None)  # each arm installs its own mesh around its calls
            return t, p, opt

        def on(t, fn):
            set_kernel_mesh(t._mesh)
            try:
                return fn()
            finally:
                set_kernel_mesh(None)

        # a. one batch's losses and gradients, mesh against unsharded
        arms = {"mesh": trainer("mesh", True), "single": trainer("single", False)}
        need(arms["mesh"][0]._mesh.shape == {"data": MESH[0], "model": MESH[1]},
             f"mesh shape {arms['mesh'][0]._mesh.shape}")
        def grads_of(k, replay=None):
            t, p, _ = arms[k]
            staged = t._stage_batch(dict(items[0]))
            zero_counts()
            with relu_patterns(replay) as seen:
                losses, grads = on(t, lambda: t._grads(cfg, p, staged[0], staged[2],
                                                       torch.Generator().manual_seed(seed), 1.0))
                torch.cuda.synchronize()
            launch = read_counts(("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"))
            # the gathered gradient tree: slices joined in shard order
            tree = dict(named_leaves(gather_params(_fill(p, [g.detach() for g in grads]))))
            return float(sum(losses.values())), tree, launch, seen

        def worst_of(got, want):
            rel = {n: float((got[n] - b).abs().max()) / max(float(b.norm()), 1e-30)
                   for n, b in want.items()}
            n = max(rel, key=rel.get)
            return rel[n], n

        # the mesh step's FFNs call relu once a model shard on its columns of
        # the unsharded call's: replayed on the unsharded step's pieces (cut
        # per shard), the two steps differ by rounding alone (phase 6's way).
        # The pieces the arms part on must be few and each a tie: the arms'
        # pre-activations may differ by at most RELU_BAND of each call's
        # largest (so a parted piece's unsharded pre-activation lies that
        # close to 0), which a wrong shard of w_1 or b_1 cannot meet.
        single = grads_of("single")
        raw = grads_of("mesh")
        pre = [c for x in single[3] for c in x.chunk(MESH[1], dim=-1)]
        pieces = [c > 0 for c in pre]
        mesh = grads_of("mesh", replay=pieces)
        worst, worst_leaf = worst_of(mesh[1], single[1])
        raw_worst, raw_leaf = worst_of(raw[1], single[1])
        flips, band_rel, flip_rel = 0, 0.0, 0.0
        for a, b in zip(raw[3], pre, strict=True):
            flip = (a > 0) != (b > 0)
            top = max(float(b.abs().max()), 1e-30)
            band_rel = max(band_rel, float((a - b).abs().max()) / top)
            flips += int(flip.sum())
            if flip.any():
                flip_rel = max(flip_rel, float(b[flip].abs().max()) / top)
        relu_entries = sum(c.numel() for c in pre)
        pre = None
        loss_rel = abs(raw[0] - single[0]) / max(abs(single[0]), 1e-30)
        doubled = {k: (raw[2][k], single[2][k]) for k in ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd")}
        single = raw = mesh = pieces = None
        # steps in turns, then one profiled step each way
        secs = {k: [] for k in arms}
        launches = None
        for i in range(7):
            for k, (t, p, opt) in arms.items():
                if i == 2 and k == "mesh":
                    zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                on(t, lambda: t._train_batch(cfg, p, opt, dict(items[i % 2]), i + 1))
                torch.cuda.synchronize()
                secs[k].append(time.perf_counter() - t0)
                if i == 2 and k == "mesh":
                    launches = read_counts(("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"))
        runs.append(launches)
        prof, peak = {}, {}
        for k, (t, p, opt) in arms.items():
            torch.cuda.reset_peak_memory_stats()
            prof[k] = step_profile(lambda: on(t, lambda: t._train_batch(
                cfg, p, opt, dict(items[0]), 8)))
            peak[k] = torch.cuda.max_memory_allocated() / 2 ** 30
        say("mesh train a", mode="ASR_ST", mesh=list(MESH), B=B, frames=FRAMES,
            dropout=cfg.dropout, loss_mesh_vs_single_rel=loss_rel, grad_max_rel_err=worst,
            worst_leaf=worst_leaf, tol=1e-5, relu_entries=relu_entries, relu_flips=flips,
            relu_flips_max=RELU_FLIPS_MAX, relu_band_rel=band_rel, relu_band_max=RELU_BAND,
            relu_flip_pre_rel=flip_rel,
            grad_max_rel_err_own_pieces=raw_worst, its_leaf=raw_leaf,
            **{f"{k}_step_ms": [round(x * 1e3, 3) for x in v[2:]] for k, v in secs.items()},
            **{f"{k}_median_ms": round(statistics.median(v[2:]) * 1e3, 3)
               for k, v in secs.items()},
            **{f"{k}_{m}": v for k, pr in prof.items() for m, v in pr.items()},
            **{f"{k}_peak_mem_gib": round(v, 4) for k, v in peak.items()})
        need(loss_rel <= 1e-5, f"mesh loss off by {loss_rel} relative")
        need(worst <= 1e-5, f"mesh gradient {worst_leaf} off by {worst} of its norm")
        need(flips <= RELU_FLIPS_MAX, f"{flips} ReLU pieces part the mesh and unsharded steps")
        need(band_rel <= RELU_BAND, f"the mesh step's FFN pre-activations are off by {band_rel} "
                                    f"of their largest: its parted ReLU pieces are no ties")
        say("mesh train b", launches_mesh_vs_single={k: list(v) for k, v in doubled.items()})
        need(all(m == 2 * s_ > 0 for m, s_ in doubled.values()),
             f"K8/K9 launches a mesh step are not twice the unsharded step's: {doubled}")
        del arms

        # c. dev eval under the (2, 2) mesh
        runs.append(phase_tp_dev_eval(params, cfg, rng, shape=MESH,
                                      label="mesh train c dev eval"))

        # d. save on the mesh, load unsharded; resume on the mesh
        ta, pa, oa = trainer("d_mesh", True)
        for i in range(2):
            on(ta, lambda: ta._train_batch(cfg, pa, oa, dict(items[i]), i + 1))
        gen = ta._root_gen.get_state()
        saved = ta._save(cfg, pa, oa, 1, 2, _Vocab()).path
        tu, pu, ou = trainer("d_single", False, load_dir=saved, load_mode="resume")
        differ = {}
        for what, mine, theirs in (("params", gather_params(pa), pu),
                                   ("adam", ta._tx.state_tree(pa, oa), tu._tx.state_tree(pu, ou))):
            a, b = dict(named_leaves(mine)), dict(named_leaves(theirs))
            differ[what] = sorted(set(a) ^ set(b)) + [
                n for n in a if n in b and not (a[n].dtype == b[n].dtype
                                                and torch.equal(a[n].cpu(), b[n].cpu()))]
        n_adam = len(named_leaves(ta._tx.state_tree(pa, oa)))
        del tu, pu, ou
        tr, pr, orr = trainer("d_resume", True, load_dir=saved, load_mode="resume")
        tr._root_gen.set_state(gen)
        on(tr, lambda: tr._train_batch(cfg, pr, orr, dict(items[2]), 3))
        tb, pb, ob = trainer("d_cont", True)
        for i in range(3):
            on(tb, lambda: tb._train_batch(cfg, pb, ob, dict(items[i]), i + 1))
        resumed = {}
        for what, mine, theirs in (("params", gather_params(pr), gather_params(pb)),
                                   ("adam", tr._tx.state_tree(pr, orr), tb._tx.state_tree(pb, ob))):
            a, b = named_leaves(mine), named_leaves(theirs)
            resumed[what] = [n for (n, x), (_, y) in zip(a, b, strict=True)
                             if not torch.equal(x.cpu(), y.cpu())]
        say("mesh train d", adam_leaves=n_adam, loaded_params_bit_equal=not differ["params"],
            loaded_adam_bit_equal=not differ["adam"],
            resumed_params_bit_equal=not resumed["params"],
            resumed_adam_bit_equal=not resumed["adam"])
        need(not differ["params"] and not differ["adam"],
             f"mesh checkpoint loaded unsharded differs: {differ['params'][:3]} {differ['adam'][:3]}")
        need(not resumed["params"] and not resumed["adam"],
             f"mesh resume differs from the run that never stopped: "
             f"{resumed['params'][:3]} {resumed['adam'][:3]}")
        del ta, pa, oa, tr, pr, orr, tb, pb, ob

        # e. the CLI with --n_model 2 on the one card
        corpus = write_corpus(tmp / "corpus", seed, utts={"train": 4 * B})
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        logging.getLogger("stjep_tpu_torch.parallel.mesh").addHandler(handler)
        finals = {}
        try:
            for n in ("1", "2"):
                te, (_, finals[n]) = cli.main(cli_argv(corpus, tmp / f"e{n}", seed,
                                                       "--n_model", n), device="cuda")
                need(te.steps_run == 4, f"--n_model {n}: {te.steps_run} steps")
                need((te._mesh is None) == (n == "1"), f"--n_model {n}: mesh {te._mesh}")
        finally:
            logging.getLogger("stjep_tpu_torch.parallel.mesh").removeHandler(handler)
        warned = [r.getMessage() for r in records]
        differ = [n for (n, a), (_, b) in zip(named_leaves(finals["2"]), named_leaves(finals["1"]),
                                              strict=True) if not torch.equal(a, b)]
        say("mesh train e", mesh=te._mesh.shape, warning=repr(warned[:1]), steps=te.steps_run,
            params_bit_equal_to_n_model_1=not differ, kernel_mesh_after=kernel_mesh())
        need(te._mesh.shape == {"data": 1, "model": 1} and any(
            "does not divide 1 devices" in w for w in warned), f"--n_model 2: {warned}")
        need(not differ, f"--n_model 2 differs from --n_model 1: {differ[:3]}")
        need(kernel_mesh() is None, "the CLI left a kernel mesh installed")

    # f. ACT dev eval rows 0-1 under a (1, 2) mesh
    from stjep_tpu_torch.config import BOS

    acfg = ModelConfig(**{**FLAGSHIP, "transformer_type": "universal", "act": True})
    aparams = init_seq2seq(acfg, torch.Generator().manual_seed(seed + 5), "cuda")
    feats, lens = inputs(rng, 2)
    refs = {"ref_src": torch.from_numpy(rng.randint(5, acfg.enc_vocab_size, (2, acfg.max_seq_len_src))),
            "ref_tgt": torch.from_numpy(rng.randint(5, acfg.dec_vocab_size, (2, acfg.max_seq_len_tgt)))}
    for r in refs.values():
        r[:, 0] = BOS
    run = lambda: {k: v.cpu() for k, v in forward_eval(  # noqa: E731
        aparams, acfg, "ASR_ST", acous_feats=feats, acous_lens=lens, device="cuda",
        **refs).items()}
    alone = run()
    set_kernel_mesh(make_mesh(1, 2, ["cuda"] * 2))
    try:
        zero_counts()
        meshed = run()
        act_launches = read_counts(LAS_RAN, DENSE_IDLE + TP_RAN)
    finally:
        set_kernel_mesh(None)
    differ = [k for k in alone if not torch.equal(alone[k], meshed[k])]
    say("mesh train f", act_rows=2, mesh=[1, 2], outputs_equal=not differ,
        launches={k: v for k, v in act_launches.items() if v})
    need(not differ, f"ACT dev eval under a (1, 2) mesh differs: {differ}")
    runs.append(act_launches)
    say("mesh train", seconds=round(time.perf_counter() - t_start, 1))
    return runs


class _Vocab:
    vocab_src, vocab_tgt = ["a"], ["b"]


def _fill(layout, values):
    """The training layout's structure with its leaves replaced, in
    bridge.leaves order, by `values` (a gradient a leaf)."""
    from stjep_tpu_torch.parallel.mesh import Shards

    it = iter(values)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, Shards):
            return Shards(next(it) for _ in tree)
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return next(it)

    return walk(layout)


MP_RANKS = 2  # the multi-process phase's ranks, all on the card
MP_TIMEOUT = 300  # seconds a rank may take before the phase fails
MP_SEED_OFFSET = 11  # the phase's params and batches: multiproc_worker's --seed


def phase_multiproc_train(seed):
    """(a)-(e) of phase 12. Returns the ranks' launch counts of e's timed
    steps, summed over the ranks."""
    import tempfile

    from stjep_tpu_torch.bridge import named_leaves, params_to
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.models.seq2seq import init_seq2seq
    from stjep_tpu_torch.scripts import multiproc_worker as W
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.trainer import make_train_step, step_grads

    t_start = time.perf_counter()
    S = seed + MP_SEED_OFFSET
    cfg = ModelConfig(**FLAGSHIP)
    init = init_seq2seq(cfg, torch.Generator().manual_seed(S), "cpu")
    mb = W.tensor_item(W.make_item(cfg, B, FRAMES, S, 0))
    names = [n for n, _ in named_leaves(init)]
    with tempfile.TemporaryDirectory(prefix="stjep_multiproc_") as tmp:
        work = Path(tmp)
        # the one-process step on the card: a and b's reference (and its
        # ReLU pieces, which the ranks replay), e's step time
        single = {}
        for drop in ("off", "on"):
            params = params_to(init, "cuda")
            with W.dropout_off(drop), W.relu_patterns() as pre:
                losses, grads = step_grads(W.job_cfg(cfg, drop), "ASR_ST", params, [mb],
                                           torch.Generator().manual_seed(S), "cuda")
                torch.cuda.synchronize()
            single[drop] = (float(sum(losses.values())), [g.detach().cpu() for g in grads],
                            list(pre))
            np.savez(work / f"pieces_grads_{drop}.npz", *[(x > 0).numpy() for x in pre])
            del params, grads
        params = params_to(init, "cuda")
        opt = make_optimizer(1.0)
        state = opt.init(params)
        step = make_train_step(cfg, "ASR_ST", opt, device="cuda")
        gen, secs = torch.Generator().manual_seed(S), []
        mb_c = {k: v.cuda() for k, v in mb.items()}
        zero_counts()
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, _ = step(params, state, [mb_c], gen, TRAIN_LR)
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) * 1e3)
        one = read_counts(("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"))
        one = {k: v / len(secs) for k, v in one.items() if k.startswith(("K8", "K9"))}
        del params, state, step, mb_c
        torch.cuda.empty_cache()  # the ranks share the card

        # the ranks
        t_ranks = time.perf_counter()
        jobs = "grads:off,grads:on,steps:on,trainer:on:3"
        cmd = [sys.executable, "-m", "stjep_tpu_torch.scripts.multiproc_worker",
               "--init", f"file://{work / 'rendezvous'}", "--world", str(MP_RANKS),
               "--workdir", str(work), "--device", "cuda", "--cfg", json.dumps(FLAGSHIP),
               "--batch", str(B), "--frames", str(FRAMES), "--seed", str(S),
               "--lr", str(TRAIN_LR), "--jobs", jobs, "--relu", "--save_arrays",
               "--timeout", str(MP_TIMEOUT)]
        here = str(Path(__file__).resolve().parent)
        env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
        logs = [open(work / f"log{r}.txt", "w+") for r in range(MP_RANKS)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=here, env=env,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(MP_RANKS)]
        try:
            deadline = time.perf_counter() + MP_TIMEOUT
            for r, proc in enumerate(procs):
                try:
                    proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"rank {r} ran past {MP_TIMEOUT} s") from None
            for r, proc in enumerate(procs):
                logs[r].seek(0)
                need(proc.returncode == 0, f"rank {r} exited {proc.returncode}: "
                     + " ".join(logs[r].read()[-1500:].split()))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in logs:
                f.close()
        ranks_s = time.perf_counter() - t_ranks
        metas = []
        for r in range(MP_RANKS):
            with np.load(work / f"rank{r}.npz") as d:
                metas.append(json.loads(str(d["meta"])))
        m0 = metas[0]

        # a, b: losses and gradients against the one-process step's
        arrays = np.load(work / "rank0.npz")
        for part, drop in (("a", "off"), ("b", "on")):
            tag = f"grads_{drop}"
            loss1, grads1, pre1 = single[drop]
            need(all(m[f"{tag}_own_losses"] == m0[f"{tag}_own_losses"] for m in metas),
                 f"{part}: the ranks' losses differ")
            loss = sum(m0[f"{tag}_own_losses"].values())
            loss_rel = abs(loss - loss1) / max(abs(loss1), 1e-30)
            rel = {n: float((torch.from_numpy(arrays[f"{tag}/grad{n}"]) - g).abs().max())
                   / max(float(g.norm()), 1e-30) for n, g in zip(names, grads1)}
            worst_leaf = max(rel, key=rel.get)
            pres = [np.load(work / f"pre_{tag}_rank{r}.npz") for r in range(MP_RANKS)]
            flips, band_rel = 0, 0.0
            for i, b in enumerate(pre1):
                a = torch.cat([torch.from_numpy(p[f"arr_{i}"]) for p in pres])
                top = max(float(b.abs().max()), 1e-30)
                band_rel = max(band_rel, float((a - b).abs().max()) / top)
                flips += int(((a > 0) != (b > 0)).sum())
            say(f"multi-process train {part}", ranks=MP_RANKS, backend=m0["backend"],
                dropout="off" if drop == "off" else cfg.dropout, spec_aug=drop == "on", B=B,
                rows_a_rank=B // MP_RANKS, frames=FRAMES, loss=loss, loss_rel=loss_rel,
                grad_max_rel_err=rel[worst_leaf], worst_leaf=worst_leaf, tol=1e-5,
                relu_calls=len(pre1), relu_flips=flips, relu_flips_max=RELU_FLIPS_MAX,
                relu_band_rel=band_rel, relu_band_max=RELU_BAND)
            need(loss_rel <= 1e-5, f"{part}: two-rank loss off by {loss_rel} relative")
            need(rel[worst_leaf] <= 1e-5,
                 f"{part}: two-rank gradient {worst_leaf} off by {rel[worst_leaf]} of its norm")
            need(flips <= RELU_FLIPS_MAX, f"{part}: {flips} ReLU pieces part the ranks' step")
            need(band_rel <= RELU_BAND, f"{part}: the ranks' FFN pre-activations are off by "
                                        f"{band_rel} of their largest")
        arrays.close()
        single = None

        # c, d: the Trainer, its checkpoint
        tag = "trainer_on_3"
        same = {k: len({m[f"{tag}_{k}"] for m in metas}) == 1
                for k in ("params_digest", "adam_digest", "path")}
        say("multi-process train c", steps=3, params_bit_equal=same["params_digest"],
            adam_bit_equal=same["adam_digest"], digest=m0[f"{tag}_params_digest"][:16],
            cut=[m[f"{tag}_cut"] for m in metas], losses=m0[f"{tag}_losses"])
        need(same["params_digest"] and same["adam_digest"],
             "the ranks' params or Adam states differ after 3 Trainer steps")
        need(all(m[f"{tag}_cut"] for m in metas), "the Trainer did not cut the batch")
        writes = [m[f"{tag}_writes"] for m in metas]
        loaded = [m[f"{tag}_loaded_params_equal"] and m[f"{tag}_loaded_adam_equal"]
                  for m in metas]
        say("multi-process train d", msgpack_writes=writes, dirs=m0[f"{tag}_saved_dirs"],
            same_path=same["path"], loaded_bit_equal=loaded)
        need(writes == [2] + [0] * (MP_RANKS - 1) and len(m0[f"{tag}_saved_dirs"]) == 1
             and same["path"], f"checkpoint writes {writes}, dirs {m0[f'{tag}_saved_dirs']}")
        need(all(loaded), f"a rank's checkpoint load differs from its state: {loaded}")

        # e: the timings and the launches
        tag = "steps_on"
        launches = {k: sum(m[f"{tag}_launches"][k] for m in metas)
                    for k in m0[f"{tag}_launches"]}
        n = m0[f"{tag}_timed_steps"]
        say("multi-process train e", backend=m0["backend"],
            **{f"rank{r}_step_ms": m[f"{tag}_step_ms"] for r, m in enumerate(metas)},
            **{f"rank{r}_median_ms": statistics.median(m[f"{tag}_step_ms"])
               for r, m in enumerate(metas)},
            one_process_step_ms=secs[2:], one_process_median_ms=statistics.median(secs[2:]),
            all_reduce_ms=m0[f"{tag}_all_reduce_ms"],
            all_reduce_median_ms=statistics.median(m0[f"{tag}_all_reduce_ms"]),
            all_reduce_bytes=m0[f"{tag}_bucket_bytes"],
            launches_a_step_a_rank={k: [m[f"{tag}_launches"][k] / n for m in metas]
                                    for k in launches},
            one_process_launches_a_step=one,
            losses=m0[f"{tag}_step_losses"], ranks_s=round(ranks_s, 1),
            **{f"rank{r}_jobs_s": {k[:-8]: round(v, 1) for k, v in m.items()
                                   if k.endswith("_seconds")} for r, m in enumerate(metas)})
        need(all(m[f"{tag}_params_digest"] == m0[f"{tag}_params_digest"] for m in metas),
             "the ranks' params differ after make_train_step's steps")
        need(all(np.isfinite(m0[f"{tag}_step_losses"])), "non-finite two-rank loss")
        need(all(m[f"{tag}_launches"][k] == n * one[k] > 0 for m in metas for k in one),
             f"K8/K9 launches a rank over {n} steps: {[m[f'{tag}_launches'] for m in metas]}, "
             f"not the one-process step's {one} each step")
    say("multi-process train", seconds=round(time.perf_counter() - t_start, 1))
    return [launches]


# the recipe phase: each stage's kernels that must launch, and must not. ST
# trains its LAS free running, through the differentiable step loop (K2 has
# no backward; JAX runs its XLA scan there), so no K9 in ST
RECIPE_RAN = {"asr": ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"), "emb": ("K1", "K9 fwd"),
              "mt": (), "asr_st": ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd"),
              "st": ("K8 fwd", "K8 bwd"), "decode": ("K1", "K2", "K3", "K4")}
RECIPE_IDLE = {"mt": ("K8 fwd", "K8 bwd"), "st": ("K9 fwd", "K9 bwd")}
# phase b's kernels: at the quality widths (D 32, 2H 32) the LAS decoder runs
# its step loop, not K2 or K9, on JAX's gate (ops/las_flash.py
# las_flash_supported: D and 2H multiples of 128)
QUALITY_RAN = ("K1", "K3 gather", "K3", "K4", "K8 fwd", "K8 bwd")
QUALITY_IDLE = ("K2", "K9 fwd", "K9 bwd")
QUALITY_EPOCHS = 4  # phase b's epochs a stage: a smoke run, too short to hold the band
QUALITY_B = 32  # the quality run's train batch, and its dev eval's


@contextlib.contextmanager
def first_call(owner, name, store, want, keep, n=1):
    """While open, owner.<name> appends keep(args, kwargs, output) to
    `store` at its first n calls that want(args, kwargs) picks."""
    orig = getattr(owner, name)

    def recording(*a, **kw):
        out = orig(*a, **kw)
        if len(store) < n and want(a, kw):
            store.append(keep(a, kw, out))
        return out

    setattr(owner, name, recording)
    try:
        yield store
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def step_mode(now):
    """While open, now["mode"] is the MODE of the Trainer whose _step runs,
    and None between steps."""
    from stjep_tpu_torch.train import trainer as trainer_mod

    orig = trainer_mod.Trainer._step

    def marking(self, *a, **kw):
        now["mode"] = self.MODE
        try:
            return orig(self, *a, **kw)
        finally:
            now["mode"] = None

    trainer_mod.Trainer._step = marking
    try:
        yield now
    finally:
        trainer_mod.Trainer._step = orig


@contextlib.contextmanager
def recording_quality(evals, decodes, k8_calls):
    """While open, a quality run's main-path inputs are recorded for
    hold_quality: the joint stage's first dev eval at B = QUALITY_B (CPU
    params, cfg, mode, kwargs, outputs) into evals, the ST beam-5 decode's
    first batch (card params, cfg, kwargs, tokens) into decodes, and the
    joint stage's first train step's K8 layers (bilstm_dp's arguments: the
    layer's params, input and lengths) into k8_calls. Yields step_mode's
    dict."""
    import stjep_tpu_torch.infer.forward as fwd_mod
    import stjep_tpu_torch.models.las_encoder as las_enc_mod
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.ops.lstm_pallas_bwd import bilstm_pallas_trainable
    from stjep_tpu_torch.train import trainer as trainer_mod

    now = {"mode": None}
    with step_mode(now), \
            first_call(las_enc_mod, "bilstm_dp", k8_calls,
                       lambda a, kw: now["mode"] == "ASR_ST" and a[0] is bilstm_pallas_trainable,
                       lambda a, kw, o: host_copy(a[1:]),
                       n=ModelConfig().num_pyramid_layers), \
            first_call(trainer_mod, "forward_eval", evals,
                       lambda a, kw: a[2] == "ASR_ST" and kw["acous_feats"].shape[0] == QUALITY_B,
                       lambda a, kw, o: (host_copy(a[0]), a[1], a[2], host_copy(kw),
                                         host_copy(o))), \
            first_call(fwd_mod, "forward_translate", decodes,
                       lambda a, kw: a[2] == "ST" and kw["beam_width"] == BEAM,
                       lambda a, kw, o: (a[0], a[1], host_copy(kw), host_copy(o))):
        yield now


def host_copy(tree):
    """A copy on the host of every tensor in a tree of dicts, lists and
    tuples (other leaves as they are): the Trainer updates its params in
    place, and the loader reuses its host buffers for the next batch."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if torch.is_tensor(tree) else tree


def hold_quality(label, ev, dec, k8_calls, rng):
    """A quality run's kernels held against their plain versions on the
    main path's own inputs (recording_quality's records): the joint
    stage's first dev eval at B = QUALITY_B (K1, K3's gather variant, and
    K2 where the LAS passes JAX's gate; `ev`) through hold_eval; the ST
    beam-5 decode's first batch (K1, K3, K4, K2 likewise; `dec`) again on
    the card with its beam states recorded and on CPU copies, differing
    rows explained by ties (explain_e2e); K8 forward and backward layer by
    layer (k8_layer) on the joint stage's first train step's layers
    (`k8_calls`)."""
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.models.seq2seq import forward_eval

    (pc_e, cfg_e, mode, kw_e, out_g), (pg_d, cfg_d, kw_d, toks) = ev, dec  # on the host but pg_d
    kw_e = {k: v for k, v in kw_e.items() if k != "device"}
    run = lambda p, d, **kw: forward_eval(p, cfg_e, mode, device=d, **{**kw_e, **kw})
    margins_e, err_e, plain_e = hold_eval(f"{label} dev eval", run, out_g, pc_e)

    feats, lens, n_pos = kw_d["acous_feats"], kw_d["acous_lens"], kw_d["max_seq_len"]
    card = recorded_translate(pg_d, cfg_d, feats, lens, "cuda", max_seq_len=n_pos)
    need(torch.equal(card[0], toks), f"{label}: the ST decode's batch not reproducible")
    pc_d = host_copy(pg_d)
    t0 = time.perf_counter()
    plain = recorded_translate(pc_d, cfg_d, feats, lens, "cpu", max_seq_len=n_pos)
    plain_d = time.perf_counter() - t0
    margins_d = explain_e2e(pc_d, cfg_d, feats, lens, card, plain)

    rel, k8_shapes = {"fwd": 0.0, "bwd": 0.0}, []
    for pf, pb, x, n_ in k8_calls:
        p = {"fwd": params_to(pf, "cuda"), "bwd": params_to(pb, "cuda")}
        _, _, _, fwd, fplain, _, a, b = k8_layer(p, rng, *x.shape, n_.long().cuda(),
                                                 x=x.float().cuda())
        k8_shapes.append(list(x.shape))
        rel["fwd"] = max([rel["fwd"]] + [rel_err(c, d) for c, d in zip(fwd, fplain)])
        rel["bwd"] = max(rel["bwd"], rel_err(a, b))
    say(f"{label} held",
        dims=f"D{cfg_e.dim_model}/{cfg_e.num_heads}heads/H{cfg_e.acous_hidden_size}",
        eval_batch=list(kw_e["acous_feats"].shape), eval_rows_differ=len(margins_e),
        eval_max_margin=max(margins_e, default=0.0), picked_max_abs_err=err_e,
        picked_tol=EVAL_TOL, eval_plain_cpu_s=round(plain_e, 1),
        decode_batch=list(feats.shape), decode_positions=n_pos,
        decode_rows_differ=len(margins_d), decode_max_margin=max(margins_d, default=0.0),
        margin_limit=E2E_MARGIN, decode_plain_cpu_s=round(plain_d, 1),
        k8_layer_inputs=k8_shapes,
        k8_max_rel_err=rel, k8_tol_rel=K8_TOL)
    need_eval_held(f"{label} dev eval", margins_e, err_e)
    need(all(m <= E2E_MARGIN for m in margins_d),
         f"{label} ST decode rows differ beyond ties: margins {margins_d}")
    need(all(rel[k] <= K8_TOL[k] for k in rel), f"{label} K8 relative errors {rel} > {K8_TOL}")


def phase_recipe(seed):
    """a. stjep_tpu_torch/scripts/full_recipe.py at the flagship widths on
    the train cli phase's corpus (recipe_a); b. quality_ab.py, seed 333,
    QUALITY_EPOCHS + QUALITY_EPOCHS epochs, and its kernels held against
    their plain versions on its own inputs (recipe_b). Returns the runs'
    launch counts."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stjep_recipe_") as tmp:
        runs = recipe_a(Path(tmp), seed) + recipe_b(Path(tmp), seed)
    say("recipe", seconds=round(time.perf_counter() - t_phase, 1))
    return runs


def recipe_a(tmp, seed):
    """The six stages at the flagship on a CORPUS_UTTS corpus in tmp, each
    stage's launches, the script's checks, and the decode's lines against
    forward_translate on the same staged batches. Returns each stage's
    launch counts."""
    import dataclasses

    from stjep_tpu_torch.cli import translate as tcli
    from stjep_tpu_torch.data.dataset import Dataset
    from stjep_tpu_torch.scripts import full_recipe

    runs = []
    corpus = write_corpus(tmp / "corpus", seed, CORPUS_UTTS)
    res = full_recipe.run(str(tmp / "a"), device="cuda", dims="flagship", corpus=corpus,
                          log=lambda line: print(line, flush=True))
    stages = {s["stage"]: s for s in res["stages"]}
    for name, rec in stages.items():
        got = rec["launches"]
        need(all(got[k] > 0 for k in RECIPE_RAN[name])
             and not any(got[k] for k in RECIPE_IDLE.get(name, ())),
             f"stage {name}: launches {got}, expected > 0 for {list(RECIPE_RAN[name])}, "
             f"0 for {list(RECIPE_IDLE.get(name, ()))}")
        runs.append(got)
    # stage 6 against bare forward_translate on the same staged batches
    cfg, pg, ck = tcli._load_model(res["st_ckpt"], "cuda")
    ds = Dataset(path_src=corpus["dev_src"], path_tgt=corpus["dev_tgt"],
                 vocab_src_list=ck.input_vocab, vocab_tgt_list=ck.output_vocab,
                 use_type="char", acous_path=corpus["dev_flis"], acous_max_len=6000,
                 max_seq_len_src=900, max_seq_len_tgt=900, batch_size=B, mode="ST")
    ds.construct_batches(is_train=False)
    items = [ds.materialise_batch(i) for i in range(len(ds))]
    need(res["decode"] == {"batch_size": B, "beam_width": BEAM, "max_seq_len": DECODE_LEN},
         f"the recipe decodes with {res['decode']}")
    want = cli_staged_lines(pg, dataclasses.replace(cfg, max_seq_len_src=150), ds, items,
                            "ST")
    lines = Path(res["translate"]).read_text(encoding="utf8").splitlines()
    need(lines == want, f"recipe decode: the CLI's lines differ from forward_translate's "
         f"on the same staged batches ({sum(a != b for a, b in zip(lines, want))} rows)")
    say("recipe a", stages=len(stages),
        seconds={k: round(v["seconds"], 3) for k, v in stages.items()},
        asr_leaves_loaded=stages["asr_st"]["asr_leaves_loaded"],
        frozen_check=stages["st"]["frozen_check"], decoded=len(lines),
        nonempty_rows=sum(map(bool, lines)), lines_equal_bare=True)
    return runs


def recipe_b(tmp, seed):
    """quality_ab.py for seed 333 at QUALITY_EPOCHS + QUALITY_EPOCHS epochs
    in tmp: it finishes and writes its JSON, its launches; then
    hold_quality on its recorded joint dev eval and ST decode. Returns its
    launch counts."""
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.scripts import quality_ab
    from stjep_tpu_torch.utils.profiling import launch_counts, zero_launch_counts

    out = tmp / "quality.json"
    evals, decodes, k8_calls = [], [], []
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_quality(evals, decodes, k8_calls):
        rc = quality_ab.main(["--device", "cuda", "--workdir", str(tmp / "b"),
                              "--epochs_asr", str(QUALITY_EPOCHS),
                              "--epochs_joint", str(QUALITY_EPOCHS), "--seeds", "333",
                              "--out", str(out)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launch_counts()
    need(rc == 0 and out.exists(), f"quality_ab exited {rc}")
    q = json.loads(out.read_text())
    r = q["runs"][0]
    need(q["status"] == "partial" and r["steps"]["asr"] == QUALITY_EPOCHS * 12
         and r["steps"]["joint"] == QUALITY_EPOCHS * 12,
         f"quality seed: status {q['status']}, steps {r['steps']}")
    need(all(got[k] > 0 for k in QUALITY_RAN) and not any(got[k] for k in QUALITY_IDLE),
         f"quality seed launches {got}: expected > 0 for {list(QUALITY_RAN)}, 0 for "
         f"{list(QUALITY_IDLE)}")
    say("recipe b", seed=r["seed"], epochs=[QUALITY_EPOCHS, QUALITY_EPOCHS],
        seconds=round(secs, 3), wall_s={k: round(v, 3) for k, v in r["wall_s"].items()},
        steps=r["steps"], asr_dev_wer=r["asr_dev_wer"], st_dev_bleu=r["st_dev_bleu"],
        wer_bleu_held="no (too short for the band)", card=repr(r["card"]),
        launches={k: v for k, v in got.items() if v})
    need(len(evals) == 1 and len(decodes) == 1
         and len(k8_calls) == ModelConfig().num_pyramid_layers,
         f"quality seed: {len(evals)} joint dev evals at B={QUALITY_B}, {len(decodes)} "
         f"ST beam decodes, {len(k8_calls)} joint K8 layers recorded")
    hold_quality("recipe b", evals[0], decodes[0], k8_calls, np.random.RandomState(seed + 13))
    return [got]


# phase 14: quality.py's kernel profile (D 128, 2H 128: JAX's gate sends the
# LAS through K2 and K9) on the full corpus, each stage's kernels, and the
# eval audit's 15 cells on its joint checkpoint
QK_EPOCHS = 2  # a training stage's epochs: 24 steps on the 360 + 48 corpus
QK_RAN = {"asr": ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd", "K1", "K2"),
          "emb": ("K1", "K9 fwd"),
          "asr_st": ("K8 fwd", "K8 bwd", "K9 fwd", "K9 bwd", "K1", "K2", "K3 gather"),
          "dec_asr": ("K1", "K2"), "dec_st": ("K1", "K2", "K3", "K4 select")}
K9_TOL = 1e-3  # relative, phase_k9's


def hold_k9(label, call, rng):
    """K9 forward and backward on a recorded las_tf_scan_dp call (host
    copies of its arguments: the LSTM stack, attention and FFN weights,
    pre0, the acoustic memory, lengths and dropout masks), the arguments
    built as las_tf_scan's Function builds them, against the plain
    versions on the card; the backward on a cotangent from rng."""
    from stjep_tpu_torch.bridge import params_to
    from stjep_tpu_torch.ops import las_tf_flash as k9

    stack, att_w, ffn_w, pre0, acous, lens_k = params_to(call[:6], "cuda")
    drop = None if call[6] is None else params_to(call[6], "cuda")
    acous = acous.float().contiguous()
    w, wk, m = k9.kernel_args(acous, *k9.scan_inputs(stack, att_w, ffn_w, drop), pack=True)
    fargs = (w, pre0.float().contiguous(), wk, acous, lens_k.long(), m)
    st = k9.las_tf_fwd_plain(*fargs)
    S, Bn = pre0.shape[:2]
    g = torch.from_numpy(rng.randn(S, Bn, ffn_w.shape[1]).astype(np.float32)).cuda()
    bargs = (w, st, g, wk, acous, m)
    rel = {"fwd": max(rel_err(a, b) for a, b in zip(k9.las_tf_fwd(*fargs), st)
                      if a is not None),
           "bwd": max(rel_err(a, b) for a, b in zip(k9.las_tf_bwd(*bargs),
                                                     k9.las_tf_bwd_plain(*bargs)))}
    say(f"{label} K9 held", steps=S, B=Bn, Tk=acous.shape[1], D=w.w1.shape[1] // 4,
        two_H=acous.shape[2], masks=m is not None, max_rel_err=rel, tol_rel=K9_TOL)
    need(all(v <= K9_TOL for v in rel.values()), f"{label} K9 relative errors {rel} > {K9_TOL}")


def phase_quality_kernel(seed):
    """a. quality.py --profile kernel for QK_EPOCHS + QK_EPOCHS epochs on
    its full corpus (quality_kernel_a); b. the eval audit's 15 cells on
    a's joint checkpoint, each against the CPU (quality_kernel_b). Returns
    the runs' launch counts."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stjep_quality_kernel_") as tmp:
        runs, joint = quality_kernel_a(Path(tmp), seed)
        runs += quality_kernel_b(Path(tmp), joint)
    say("quality kernel", seconds=round(time.perf_counter() - t_phase, 1))
    return runs


def quality_kernel_a(tmp, seed):
    """quality.py at the kernel profile in tmp/a: it finishes with its
    route check passed (K9 forward and backward in every training step, K2
    in every dev eval; not judged on WER and BLEU: too short), each
    stage's kernels in QK_RAN launched; then, on the run's own inputs, K9
    forward and backward on the joint stage's first train step's LAS scan
    (hold_k9), K8 on that step's pyramid layers, and the joint stage's
    first dev eval and the ST decode's first batch against CPU copies
    (hold_quality). Returns (each stage's launch counts, the joint
    checkpoint)."""
    import stjep_tpu_torch.models.las_decoder as las_dec_mod
    from stjep_tpu_torch.config import ModelConfig
    from stjep_tpu_torch.scripts import quality

    out = tmp / "quality_kernel.json"
    evals, decodes, k9_calls, k8_calls = [], [], [], []
    t0 = time.perf_counter()
    with recording_quality(evals, decodes, k8_calls) as now, \
            first_call(las_dec_mod, "las_tf_scan_dp", k9_calls,
                       lambda a, kw: now["mode"] == "ASR_ST", lambda a, kw, o: host_copy(a)):
        rc = quality.main(["--profile", "kernel", "--device", "cuda", "--workdir",
                           str(tmp / "a"), "--epochs_asr", str(QK_EPOCHS), "--epochs_joint",
                           str(QK_EPOCHS), "--out", str(out)])
    secs = time.perf_counter() - t0
    need(out.exists(), f"quality.py exited {rc} without a result")
    q = json.loads(out.read_text())
    stages = q["stages"]
    need(rc == 0 and q["routes"]["status"] == "pass" and q["short"],
         f"quality.py exited {rc}: routes {q['routes']}, gate {q['gate']}")
    steps = {k: stages[k]["steps"] for k in quality.TRAINING}
    need(steps == {"asr": QK_EPOCHS * 12, "asr_st": QK_EPOCHS * 12}, f"steps {steps}")
    for name, ran in QK_RAN.items():
        got = stages[name]["launches"]
        need(all(got[k] > 0 for k in ran), f"stage {name}: launches {got}, expected > 0 for "
             f"{list(ran)}")
    say("quality kernel a", profile="kernel", epochs=[QK_EPOCHS, QK_EPOCHS],
        corpus=[q["corpus"]["train_sents"], q["corpus"]["dev_sents"]], seconds=round(secs, 3),
        stage_s={k: round(v["seconds"], 3) for k, v in stages.items()}, steps=steps,
        loop_steps_per_s={k: stages[k]["loop_steps_per_s"] for k in quality.TRAINING},
        steps_with={k: stages[k]["steps_with"] for k in quality.TRAINING},
        dev_evals={k: [stages[k]["dev_evals"], stages[k]["dev_evals_with"]["K2"]]
                   for k in quality.TRAINING},
        asr_dev_wer=q["asr_dev_wer"], st_dev_bleu=q["st_dev_bleu"],
        wer_bleu_held="no (too short for the gate)", card=repr(q["card"]))
    need(len(k9_calls) == 1 and len(k8_calls) == ModelConfig().num_pyramid_layers
         and len(evals) == 1 and len(decodes) == 1,
         f"recorded {len(k9_calls)} joint K9 scans, {len(k8_calls)} K8 layers, {len(evals)} "
         f"joint dev evals at B={QUALITY_B}, {len(decodes)} ST beam decodes")
    rng = np.random.RandomState(seed + 19)
    hold_k9("quality kernel", k9_calls[0], rng)
    hold_quality("quality kernel", evals[0], decodes[0], k8_calls, rng)
    joint_ckpt = tmp / "a" / "asr_st" / "checkpoints" / q["checkpoints"]["joint"]
    return [stages[k]["launches"] for k in quality.STAGES], joint_ckpt


def quality_kernel_b(tmp, joint_ckpt):
    """eval_audit.py's 15 cells at --dims kernel on a's joint checkpoint
    (mode 2 averaging a's saved checkpoints), each on the card and on the
    CPU: every cell passes (eval_audit's holds and launch rules). Returns
    the card arms' launch counts."""
    from stjep_tpu_torch.scripts import eval_audit

    t0 = time.perf_counter()
    res = eval_audit.run(str(tmp / "b"), dims="kernel", device="cuda", load=str(joint_ckpt),
                         combine_path=str(joint_ckpt.parent), log=lambda line: None)
    secs = time.perf_counter() - t0
    runs = res["runs"]
    say("quality kernel b", cells=len(runs), n_pass=res["n_pass"], n_fail=res["n_fail"],
        seconds=round(secs, 3),
        card_s={k: round(r.get("wall_s", 0.0), 3) for k, r in runs.items()},
        cpu_s={k: round(r.get("cpu_s", 0.0), 3) for k, r in runs.items()},
        rows_differ={k: r["held"].get("rows_differ") for k, r in runs.items()
                     if "rows_differ" in r.get("held", {})},
        mode3_rel_err=runs["mode3_gather_emb"].get("held", {}).get("rel_err"),
        mode4=runs["mode4_plot_emb"].get("held"),
        mode2=runs["mode2_combine"].get("leaves_not_the_mean"))
    bad = {k: {x: r.get(x) for x in ("error", "held", "launch_problems")}
           for k, r in runs.items() if r["status"] != "PASS"}
    need(len(runs) == len(eval_audit.CELLS) and not bad, f"audit cells failed: {bad}")
    return [r["launches"] for r in runs.values()]


# the step of main() that runs, for the failure line when no phase_* function
# is on the traceback
STAGE = ["arguments"]
# a phase's name on the failure line where it is not its function's
PHASE_LABELS = {"phase_multiproc_train": "multi-process train", "phase_recipe": "recipe",
                "phase_quality_kernel": "quality kernel"}


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
    train_launches, bare_steps_per_s = phase_train_e2e(args.seed, rng)
    runs.append(train_launches)
    # 8. the train CLI and Trainer around that step
    runs.append(phase_train_cli(args.seed, bare_steps_per_s))
    # 9. the translate CLI, eval modes 1-4
    runs += phase_translate_cli(args.seed, params_c, cfg)
    # 10. ACT decode and dev eval, the dense eval route, the remat step
    runs += phase_act_dense(args.seed, rng, params, params_c, cfg, reqs)
    # 11. the Trainer on a (data, model) mesh of the card
    runs += phase_mesh_train(args.seed, rng, params, cfg)
    # 12. two ranks on the card, data parallel across processes
    runs += phase_multiproc_train(args.seed)
    # 13. the staged recipe at the flagship, and a short quality seed
    runs += phase_recipe(args.seed)
    # 14. the kernel profile's quality recipe (K2, K9 in training) and the audit
    runs += phase_quality_kernel(args.seed)
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
    return PHASE_LABELS.get(names[-1], names[-1]) if names else STAGE[0]


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
