#!/usr/bin/env python3
"""One rank of a data-parallel train step across processes.

    python -m stjep_tpu_torch.scripts.multiproc_worker --init URL --world N \\
        --rank R --workdir DIR [--device cuda|cpu] [--cfg JSON] [--batch 16] \\
        [--frames 1504] [--seed 0] [--jobs grads:off,grads:on,steps:on,trainer:on] \\
        [--inputs FILE.npz] [--relu] [--save_arrays]

Start N of these, one a rank, on one rendezvous URL (`file://<path>`, or
`tcp://localhost:<port>`): each calls parallel/distributed.py's
`init_distributed`, then runs the jobs in order on a config (`--cfg`, a
ModelConfig's fields as JSON; mode ASR_ST unless it says otherwise) and batches made from `--seed`
(`make_item`; the params from `init_seq2seq`), or the params and batches
of `--inputs`. It runs on the card unless `--device cpu`. Each job is
`<kind>:<off|on>[:<steps>]`, dropout off (config dropout 0, no SpecAugment, the
attention-probability dropout 0) or as configured:

- grads: train/trainer.py step_grads on batch 0 (this rank's rows, summed
  over the ranks): the losses and, with --save_arrays on rank 0, the
  gradients. With --relu the step runs twice: on its own FFN ReLU pieces,
  recording its FFN pre-activations (its rows), then on the pieces another
  run wrote to `<workdir>/pieces_<job>.npz` (the whole batch's, cut to
  this rank's rows), whose losses and gradients it reports;
- steps: make_train_step on batch 0, 2 warm-up steps and 5 timed: each
  step's ms, the all-reduce's ms inside it and its bytes, and the K8 / K9
  launches of the timed steps;
- trainer: a Trainer_ASR_ST (batch --batch, lr --lr) taking a step a batch
  on batches 0.. (the job's steps, else 2), then saving a checkpoint and loading it
  back: digests of the params and of the Adam state, whether the load
  equals them, the checkpoint writes this rank made, the saved dir;
- whole: as trainer, one step on batch 0 cut to WHOLE_ROWS rows, a
  number that does not divide by 2 ranks;
- loop: Trainer_ASR_ST.train, one epoch of the corpus `--corpus` names
  (JSON: its paths, vocabulary sizes, acoustic dim and the config's
  max_seq_len_src and max_seq_len_tgt) at batch
  LOOP_BATCH, with dev eval on the same corpus and a checkpoint check
  every step: the digest of the params it returns (and with --save_arrays
  the params), its steps, the checkpoint dirs, whether this rank writes
  scalars.jsonl, and the lines it holds.

Everything goes to `<workdir>/rank<R>.npz` (a JSON string under "meta",
arrays beside it). chip_smoke.py's multi-process phase and
tests/test_torch_distributed.py run it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from stjep_tpu_torch.bridge import (  # noqa: E402
    named_leaves,
    params_from_numpy,
    params_to,
    params_to_numpy,
)
from stjep_tpu_torch.config import BOS, ModelConfig  # noqa: E402
from stjep_tpu_torch.models.seq2seq import init_seq2seq  # noqa: E402
from stjep_tpu_torch.ops import transformer  # noqa: E402
from stjep_tpu_torch.parallel import distributed  # noqa: E402
from stjep_tpu_torch.parallel.spmd import kernel_mesh  # noqa: E402


WHOLE_ROWS = 3  # the whole job's minibatch
LOOP_BATCH = 4  # the loop job's batch


def job_cfg(cfg: ModelConfig, dropout: str) -> ModelConfig:
    """The config of a job's dropout setting: "on" as configured, "off"
    with dropout 0 and no SpecAugment (`dropout_off` zeroes the rest)."""
    if dropout == "on":
        return cfg
    return ModelConfig(**{**cfg.__dict__, "dropout": 0.0, "spec_aug": False})


@contextlib.contextmanager
def dropout_off(dropout: str):
    """With "off": the attention-probability dropout at 0 while active."""
    real = transformer.ATTN_DROPOUT
    if dropout == "off":
        transformer.ATTN_DROPOUT = 0.0
    try:
        yield
    finally:
        transformer.ATTN_DROPOUT = real


def make_item(cfg: ModelConfig, B: int, frames: int, seed: int, i: int) -> Dict[str, np.ndarray]:
    """Batch i of a run from `seed`: fbank-shaped features with lengths in
    [frames/2, frames-8] (row 0 at frames-8), random source and target ids
    behind BOS; numpy, as the data layer gives them."""
    r = np.random.RandomState(seed * 1000 + i)
    item = {"srcid": r.randint(5, cfg.enc_vocab_size, (B, cfg.max_seq_len_src)).astype(np.int32),
            "tgtid": r.randint(5, cfg.dec_vocab_size, (B, cfg.max_seq_len_tgt)).astype(np.int32),
            "acous_feat": r.randn(B, frames, cfg.acous_dim).astype(np.float32),
            "acouslen": r.randint(frames // 2, frames - 8, (B,)).astype(np.int32)}
    item["srcid"][:, 0] = BOS
    item["tgtid"][:, 0] = BOS
    item["acouslen"][0] = frames - 8
    return item


def load_inputs(path: str, cfg: ModelConfig, seed: int):
    """(params, items) of an --inputs file: leaves "p<path>" by bridge
    path, batches "b<i>/<key>"."""
    data = np.load(path)
    params = init_seq2seq(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for name, t in named_leaves(params):
            t.copy_(torch.from_numpy(data["p" + name]))
    n = 1 + max(int(k[1:].split("/")[0]) for k in data.files if k.startswith("b"))
    items = [{k.split("/")[1]: data[k] for k in data.files if k.startswith(f"b{i}/")}
             for i in range(n)]
    return params, items


def save_inputs(path: str, params: Dict, items: List[Dict[str, np.ndarray]]):
    """The inverse of load_inputs."""
    arrays = {"p" + name: t.detach().cpu().numpy() for name, t in named_leaves(params)}
    for i, it in enumerate(items):
        arrays.update({f"b{i}/{k}": v for k, v in it.items()})
    np.savez(path, **arrays)


def digest(tree) -> str:
    """sha256 of a tree's leaves' bytes in bridge order: equal digests are
    bit-equal trees."""
    h = hashlib.sha256()
    for name, t in named_leaves(tree):
        h.update(name.encode())
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def relu_patterns(replay=None):
    """While active, torch.relu (the transformer FFNs' only kink) records
    each call's input on the host, in call order (the yielded list); given
    `replay`, one boolean pattern a call, it returns x * pattern instead:
    the linear piece another run took."""
    seen, relu = [], torch.relu

    def patched(x):
        seen.append(x.detach().cpu())
        if replay is None:
            return relu(x)
        return x * replay[len(seen) - 1].to(x.device, x.dtype)

    torch.relu = patched
    try:
        yield seen
    finally:
        torch.relu = relu


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tensor_item(item: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in item.items()}


def run_grads(args, cfg, params, items, drop, tag, out, arrays):
    from stjep_tpu_torch.train.trainer import own_rows, step_grads

    mb = tensor_item(items[0])

    def grads(replay=None):
        with dropout_off(drop), relu_patterns(replay) as seen:
            losses, gs = step_grads(job_cfg(cfg, drop), cfg.mode, params, [mb],
                                    torch.Generator().manual_seed(args.seed), args.device)
            sync(args.device)
        return {k: float(v) for k, v in losses.items()}, gs, seen

    losses, gs, seen = grads()
    if args.relu:
        np.savez(os.path.join(args.workdir, f"pre_{tag}_rank{args.rank}.npz"),
                 *[x.numpy() for x in seen])
        out[f"{tag}_own_losses"] = losses
        data = np.load(os.path.join(args.workdir, f"pieces_{tag}.npz"))
        rows = own_rows(mb["srcid"].shape[0]) or slice(None)
        pieces = [torch.from_numpy(data[f"arr_{i}"][rows]) for i in range(len(data.files))]
        losses, gs, _ = grads(pieces)
    out[f"{tag}_losses"] = losses
    out[f"{tag}_relu_calls"] = len(seen)
    if args.save_arrays and distributed.is_primary():
        names = [n for n, _ in named_leaves(params)]
        arrays.update({f"{tag}/grad{n}": g.detach().cpu().numpy() for n, g in zip(names, gs)})


def run_steps(args, cfg, params, items, drop, tag, out):
    from stjep_tpu_torch.train.optim import make_optimizer
    from stjep_tpu_torch.train.trainer import make_train_step
    from stjep_tpu_torch.utils.profiling import launch_counts, zero_launch_counts

    jc = job_cfg(cfg, drop)
    params = clone(params, args.device)
    opt = make_optimizer(1.0)
    state = opt.init(params)
    step = make_train_step(jc, cfg.mode, opt, device=args.device)
    mb = tensor_item(items[0])
    gen = torch.Generator().manual_seed(args.seed)
    reduce, times = distributed.all_reduce_sum, []

    def timed_reduce(flat):
        sync(args.device)
        t0 = time.perf_counter()
        reduce(flat)
        sync(args.device)
        times.append((time.perf_counter() - t0) * 1e3)
        out[f"{tag}_bucket_bytes"] = flat.numel() * flat.element_size()
        return flat

    distributed.all_reduce_sum = timed_reduce
    secs, losses = [], []
    try:
        with dropout_off(drop):
            for i in range(args.steps):
                if i == 2:
                    zero_launch_counts()
                    times.clear()
                distributed.barrier("step")
                sync(args.device)
                t0 = time.perf_counter()
                params, state, ls = step(params, state, [mb], gen, args.lr)
                sync(args.device)
                secs.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(sum(ls.values())))
    finally:
        distributed.all_reduce_sum = reduce
    timed = args.steps - 2
    out[f"{tag}_step_ms"] = secs[2:]
    out[f"{tag}_warmup_ms"] = secs[:2]
    out[f"{tag}_all_reduce_ms"] = times
    out[f"{tag}_step_losses"] = losses
    out[f"{tag}_launches"] = {k: n for k, n in launch_counts().items()
                              if k.startswith(("K8", "K9"))}
    out[f"{tag}_timed_steps"] = timed
    out[f"{tag}_params_digest"] = digest(params)


def run_trainer(args, cfg, params, items, drop, tag, out, arrays, n_steps, rows=None):
    from stjep_tpu_torch.parallel.mesh import gather_params
    from stjep_tpu_torch.train import checkpoint
    from stjep_tpu_torch.train.trainer import Trainer_ASR_ST

    B = args.batch if rows is None else rows
    t = Trainer_ASR_ST(expt_dir=os.path.join(args.workdir, f"expt_{tag}"), batch_size=B,
                       minibatch_partition=1, lr_warmup_steps=0, learning_rate=args.lr,
                       learning_rate_init=args.lr, seed=args.seed, device_cache=False,
                       device=args.device)
    jc = job_cfg(cfg, drop)
    p, opt, _, _ = t.setup(clone(params, args.device), jc)
    with dropout_off(drop):
        for i in range(n_steps):
            item = {k: v[:B] for k, v in items[i % len(items)].items()}
            p, opt, losses = t._train_batch(jc, p, opt, item, i + 1)
    out[f"{tag}_losses"] = {k: float(v) for k, v in losses.items()}
    out[f"{tag}_cut"] = t._rows is not None
    state = t._tx.state_tree(p, opt)
    writes, to_bytes = [], checkpoint.flax_msgpack.to_bytes

    def counted(tree):
        writes.append(1)
        return to_bytes(tree)

    checkpoint.flax_msgpack.to_bytes = counted
    try:
        path = t._save(jc, p, opt, 1, n_steps, _Vocabs()).path
    finally:
        checkpoint.flax_msgpack.to_bytes = to_bytes
    whole = gather_params(p) if t._mesh is not None else p
    ck = checkpoint.Checkpoint.load(path, params_template=params_to(whole, "cpu"),
                                    with_opt_state=True)
    out[f"{tag}_params_digest"] = digest(whole)
    out[f"{tag}_adam_digest"] = digest(state)
    out[f"{tag}_loaded_params_equal"] = digest(ck.params) == digest(whole)
    out[f"{tag}_loaded_adam_equal"] = _state_equal(ck.opt_state, state)
    out[f"{tag}_writes"] = len(writes)
    out[f"{tag}_path"] = path
    out[f"{tag}_saved_dirs"] = sorted(os.listdir(os.path.dirname(path)))
    if args.save_arrays:
        arrays.update({f"{tag}/param{n}": x.detach().cpu().numpy()
                       for n, x in named_leaves(whole)})


def _state_equal(raw, state) -> bool:
    """Whether a loaded optimizer state (flax's raw state dict: lists as
    dicts keyed "0", ..., so its paths are the state tree's) equals optax's
    state tree leaf for leaf, bit for bit."""
    got, want = dict(named_leaves(raw)), named_leaves(state)
    return len(got) == len(want) and all(
        n in got and torch.equal(torch.as_tensor(np.asarray(got[n])), x.detach().cpu())
        for n, x in want)


def clone(params: Dict, device) -> Dict:
    """A copy of params on `device` (the jobs that step update theirs in place)."""
    return params_from_numpy(params_to_numpy(params), device)


def run_loop(args, cfg, drop, tag, out, arrays):
    from stjep_tpu_torch.data.dataset import Dataset
    from stjep_tpu_torch.train.trainer import Trainer_ASR_ST

    corpus = json.loads(args.corpus)
    lcfg = job_cfg(ModelConfig(**{**cfg.__dict__, "enc_vocab_size": corpus["vocab_src_size"],
                                  "dec_vocab_size": corpus["vocab_tgt_size"],
                                  "acous_dim": corpus["acous_dim"],
                                  "max_seq_len_src": corpus["max_seq_len_src"],
                                  "max_seq_len_tgt": corpus["max_seq_len_tgt"]}), drop)

    def dataset():
        return Dataset(path_src=corpus["path_src"], path_tgt=corpus["path_tgt"],
                       path_vocab_src=corpus["path_vocab_src"],
                       path_vocab_tgt=corpus["path_vocab_tgt"], acous_path=corpus["acous_path"],
                       acous_norm_path=corpus["acous_norm_path"], acous_norm=True,
                       max_seq_len_src=lcfg.max_seq_len_src, max_seq_len_tgt=lcfg.max_seq_len_tgt,
                       batch_size=LOOP_BATCH, use_type="char", mode="ST", seed=args.seed)

    expt = os.path.join(args.workdir, f"expt_{tag}")
    t = Trainer_ASR_ST(expt_dir=expt, batch_size=LOOP_BATCH, checkpoint_every=1,
                       print_every=1,
                       lr_warmup_steps=0, learning_rate=args.lr, learning_rate_init=args.lr,
                       seed=args.seed, device_cache=False, device=args.device)
    params = init_seq2seq(lcfg, torch.Generator().manual_seed(args.seed), args.device)
    with dropout_off(drop):
        _, final = t.train({"st": dataset()}, (lcfg, params), num_epochs=1,
                           dev_sets={"st": dataset()})
    out[f"{tag}_params_digest"] = digest(final)
    out[f"{tag}_steps"] = t.steps_run
    out[f"{tag}_writes_scalars"] = t.writer._jsonl is not None
    ckpts = os.path.join(expt, "checkpoints")
    out[f"{tag}_saved_dirs"] = sorted(os.listdir(ckpts)) if os.path.isdir(ckpts) else []
    scalars = os.path.join(expt, "scalars.jsonl")
    out[f"{tag}_scalar_lines"] = sum(1 for _ in open(scalars)) if os.path.exists(scalars) else 0
    if args.save_arrays:
        arrays.update({f"{tag}/param{n}": x.detach().cpu().numpy() for n, x in named_leaves(final)})


class _Vocabs:
    vocab_src, vocab_tgt = ["a"], ["b"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init", required=True, help="rendezvous URL (file:// or tcp://)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cfg", default="{}", help="ModelConfig fields as JSON")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=1504)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--jobs", default="grads:off,grads:on")
    ap.add_argument("--inputs", default=None, help="params and batches (save_inputs)")
    ap.add_argument("--corpus", default=None, help="the loop job's corpus, JSON")
    ap.add_argument("--relu", action="store_true")
    ap.add_argument("--save_arrays", action="store_true")
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # every rank of a run on this host: gloo on the CPU or on one shared card
    distributed.init_distributed(args.init, args.world, args.rank, timeout_s=args.timeout,
                                 device=args.device, local_world_size=args.world)
    if distributed.world_size() != args.world or kernel_mesh() is not None:
        raise RuntimeError(f"rank {args.rank}: world {distributed.world_size()} of "
                           f"{args.world}, kernel mesh {kernel_mesh()}")
    cfg = ModelConfig(**{"mode": "ASR_ST", **json.loads(args.cfg)})
    if args.inputs:
        params, items = load_inputs(args.inputs, cfg, args.seed)
    else:
        params = init_seq2seq(cfg, torch.Generator().manual_seed(args.seed), "cpu")
        items = [make_item(cfg, args.batch, args.frames, args.seed, i) for i in range(3)]
    params = params_to(params, args.device)
    out, arrays = {"world": distributed.world_size(), "rank": distributed.rank(),
                   "backend": torch.distributed.get_backend()}, {}
    for job in args.jobs.split(","):
        kind, drop, *n = job.split(":")
        tag = job.replace(":", "_")
        t0 = time.perf_counter()
        if kind == "grads":
            run_grads(args, cfg, params, items, drop, tag, out, arrays)
        elif kind == "steps":
            run_steps(args, cfg, params, items, drop, tag, out)
        elif kind == "trainer":
            run_trainer(args, cfg, params, items, drop, tag, out, arrays,
                        int(n[0]) if n else 2)
        elif kind == "loop":
            run_loop(args, cfg, drop, tag, out, arrays)
        elif kind == "whole":
            run_trainer(args, cfg, params, items, drop, tag, out, arrays, 1,
                        rows=WHOLE_ROWS)
        else:
            raise ValueError(f"unknown job {job!r}")
        out[f"{tag}_seconds"] = time.perf_counter() - t0
    np.savez(os.path.join(args.workdir, f"rank{args.rank}.npz"), meta=json.dumps(out), **arrays)
    distributed.barrier("done")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
