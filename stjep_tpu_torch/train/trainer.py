"""Trainers: the train step and the host control loop (port of
stjep_tpu/train/trainer.py).

The step: per minibatch, the teacher-forced forward with ref_pick, the
masked NLL of each head and its gradient; the gradients are summed over the
minibatches (the JAX step's lax.scan), clipped over the trainable leaves
and applied by Adam (optim.py), in place. Modes ASR, MT, ST and ASR_ST; ST
alone trains through the free-running LAS decoder's differentiable step
loop; `cfg.remat` checkpoints the transformer layers (models/tf_encoder.py).
The AE modes and ACT models raise ValueError with the JAX package's
reasons (AE_NO_LOSS; models/act.py ACT_NO_GRAD): neither trains there.

`Trainer` (with the reference's class names `Trainer_ASR`, `Trainer_MT`,
`Trainer_ST`, `Trainer_ASR_ST`) is JAX's host loop around that step: epoch
shuffling, minibatch_partition grad accumulation with ragged last
minibatches, acous_bucket padding, the reference LR schedule, dev eval on
`forward_eval` with refs, checkpoint-on-improve, rollback, LR halving and
early stop, the load modes and resume, int8/bf16 feature staging, the
device-resident feature cache, and `train_window` (JAX's grouping of K
steps into windows; on the cache path every step already runs with no host
read, so a window's steps go through the single-step path). It runs on
the card unless the caller passes device="cpu"; params elsewhere raise.

On a device mesh (JAX's `_setup_mesh`: when more than one device is given
or `n_model` > 1) one process drives every shard: the params and their
Adam moments take parallel/mesh.py's training layout (the TP-ruled leaves
as n model-axis slices), each macro batch is staged whole on the mesh's
first device, the LAS kernels run per data shard (parallel/spmd.py cuts
the batch) and the transformer Megatron-style over the model axis, and the
step computes the unsharded step's function. `devices` are the mesh's devices, every visible card by
default (one device on the CPU); they may repeat, as ["cuda"] * 4 gives a
(2, 2) mesh of one card. Checkpoints hold the gathered params and
optax's unsharded state tree, whatever the mesh. A failed upload of the
device feature cache falls back to per-step staging, as JAX's does.

Across processes (JAX's mesh whose data axis spans hosts): the script
that starts each rank calls parallel/distributed.py's `init_distributed`,
then builds the Trainer or the step as usual. Each rank runs the forward and backward on its rows of
every minibatch (`Mesh.process_rows`; the Trainer cuts each macro batch on
the host, before staging), each head normalised by the whole minibatch's
mask count, which the minibatch carries (`norm_en`, `norm_de`); the
dropout draws take the rank's rows of the whole minibatch's draws
(ops/transformer.py batch_rows). The gradients and the losses are summed
over the ranks in one all_reduce of a flat bucket before the clip and
Adam, so every rank applies the same update and holds the same params and
Adam state. A minibatch whose rows do not divide by the global data axis
runs whole on every rank, with no sum, as JAX's shard_batch replicates it.
Dev eval runs whole on every rank and its numbers are rank 0's, so every
rank takes the same decisions; rank 0 alone writes checkpoints and scalars.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stjep_tpu_torch.bridge import check_params_device, leaves, named_leaves
from stjep_tpu_torch.config import PAD, ModelConfig
from stjep_tpu_torch.data.device_cache import (
    DeviceFeatureCache,
    dequantize,
    estimate_corpus_bytes,
    gather_features,
    hbm_cache_budget,
    quantize_batch,
)
from stjep_tpu_torch.data.loader import host_prefetch, to_device
from stjep_tpu_torch.models.act import ACT_NO_GRAD
from stjep_tpu_torch.models.seq2seq import forward_eval, forward_train
from stjep_tpu_torch.models.tf_encoder import uses_act
from stjep_tpu_torch.ops.losses import normalise
from stjep_tpu_torch.ops.masks import bucket_length, round_up8
from stjep_tpu_torch.ops.transformer import batch_rows, split
from stjep_tpu_torch.parallel import distributed
from stjep_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    gather_params,
    logical_leaves,
    make_mesh,
    place_params,
    process_rows,
    shard_dim,
)
from stjep_tpu_torch.parallel.spmd import kernel_mesh, set_kernel_mesh
from stjep_tpu_torch.train.checkpoint import Checkpoint
from stjep_tpu_torch.train.optim import Optimizer, make_optimizer, reference_lr, set_lr
from stjep_tpu_torch.train.policies import apply_load_mode, trainable_mask
from stjep_tpu_torch.utils import misc as _misc
from stjep_tpu_torch.utils.metrics import corpus_bleu
from stjep_tpu_torch.utils.misc import add2corpus, get_memory_alloc
from stjep_tpu_torch.utils.profiling import span

MODES = ("ASR", "MT", "ST", "ASR_ST")
LOSS_COEFF = {"nll_asr": 1.0, "nll_mt": 1.0, "nll_st": 1.0}


def head_losses(cfg: ModelConfig, mode: str, out: Dict, srcid: torch.Tensor,
                tgtid: Optional[torch.Tensor], inv_n: float,
                loss_coeff: Optional[Dict] = None, eval_with_mask: bool = True,
                normalise_loss: bool = True, norms: Optional[Dict] = None):
    """Per-head masked NLL over the picked log-probs of forward_train
    (ref_pick=True), with the reference's normalise / coefficient / 1/n_mini
    scaling. `norms` ({"norm_en", "norm_de"}: device scalars) replace the
    normalisers this batch's targets give: a process's rows of a minibatch
    are normalised by the whole minibatch's (`head_norms`). Returns (total,
    {"nll_loss_en", "nll_loss_de"})."""
    coeffs = loss_coeff or LOSS_COEFF
    norms = norms or {}
    losses = {"nll_loss_en": 0.0, "nll_loss_de": 0.0}
    total = 0.0

    def head(picked, targets, coeff, norm):
        mask = (targets != PAD).to(picked.dtype)
        if eval_with_mask:
            s = -torch.sum(picked * mask)
            norm = torch.sum(mask) if norm is None else norm.to(picked.dtype)
        else:
            s = -torch.sum(picked)
            norm = (torch.full((), float(targets.numel()), device=picked.device)
                    if norm is None else norm)
        loss = normalise(s, norm) if normalise_loss else s
        return loss * coeff * inv_n

    if "ASR" in mode:
        coeff = coeffs["nll_asr"] if mode == "ASR_ST" else 1.0
        losses["nll_loss_en"] = head(out["picked_asr"], srcid[:, 1:], coeff,
                                     norms.get("norm_en"))
        total = total + losses["nll_loss_en"]
    if mode == "MT":
        losses["nll_loss_de"] = head(out["picked_mt"], tgtid[:, 1:], coeffs["nll_mt"],
                                     norms.get("norm_de"))
        total = total + losses["nll_loss_de"]
    if "ST" in mode:
        losses["nll_loss_de"] = head(out["picked_st"], tgtid[:, 1:], coeffs["nll_st"],
                                     norms.get("norm_de"))
        total = total + losses["nll_loss_de"]
    return total, losses


def head_norms(srcid, tgtid, eval_with_mask: bool = True) -> Dict:
    """The normalisers of a whole minibatch's heads ({"norm_en", "norm_de"},
    float32 of srcid's kind: numpy arrays or tensors), over its leading
    dims but the last two: its targets' non-PAD count, or with
    eval_with_mask False their number, as head_losses takes them."""
    out = {}
    for key, ids in (("norm_en", srcid), ("norm_de", tgtid)):
        if ids is None:
            continue
        t = ids[..., 1:]
        n = ((t != PAD) if eval_with_mask else (t == t)).sum(-1).sum(-1)
        out[key] = np.asarray(n, np.float32) if isinstance(ids, np.ndarray) else n.float()
    return out


AE_NO_LOSS = (
    "the AE modes do not train: the JAX package's train step has no AE loss "
    "(it sums the ASR, MT and ST heads' NLL, stjep_tpu/train/trainer.py:261-292) "
    "and train.py has no Trainer_AE* class to pick (train.py:296); "
    "forward_train and forward_eval run the AE head")


def _check_trainable(cfg: ModelConfig, mode: str):
    """ValueError for a mode or a model the JAX package cannot train."""
    if "AE" in mode:
        raise ValueError(f"train mode {mode!r}: {AE_NO_LOSS}")
    if mode not in MODES:
        raise ValueError(f"train mode {mode!r}: the trainers are {', '.join(MODES)} "
                         "(train.py's Trainer_<mode> classes)")
    if uses_act(cfg):
        raise ValueError(ACT_NO_GRAD)


def compute_grads(cfg: ModelConfig, mode: str, params: Dict,
                  minibatches: Sequence[Dict], generator: torch.Generator,
                  is_training: bool = True, inv_n: Optional[float] = None,
                  loss_coeff: Optional[Dict] = None, eval_with_mask: bool = True,
                  normalise_loss: bool = True, cut: bool = False):
    """Summed losses and gradients over the minibatches, each loss scaled
    by inv_n (default 1 / len(minibatches); the Trainer passes 1 / the
    number of minibatches holding real rows). A minibatch holds srcid
    [B, Ls], and as the mode needs tgtid [B, Lt], acous_feat [B, T, C] and
    acouslen [B]. is_training=False gives the deterministic step (no
    dropout, no SpecAugment) that holds one device against another.
    With `cut` the minibatches are this process's rows of whole ones (rank
    r of P holds rows r*b.. of P*b), each carrying its whole minibatch's
    `head_norms`: the draws take those rows of the whole minibatch's, and
    the losses and gradients are summed over the processes (module
    docstring). Returns (losses dict of device scalars, grads in
    bridge.leaves(params) order). Reads nothing back to the host. Each
    minibatch's forward and losses are the span `stjep.train.forward`, its
    gradients and their sum `stjep.train.backward` (utils/profiling.py)."""
    _check_trainable(cfg, mode)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    if inv_n is None:
        inv_n = 1.0 / len(minibatches)
    grads = [torch.zeros_like(p) for p in ps]
    zero = torch.zeros((), device=ps[0].device)
    sums = {"nll_loss_en": zero, "nll_loss_de": zero}
    P, r = distributed.world_size(), distributed.rank()
    for mb, g in zip(minibatches, split(generator, len(minibatches))):
        b = mb["srcid"].shape[0]
        with batch_rows(r * b, P * b) if cut else contextlib.nullcontext():
            with span("stjep.train.forward"):
                out = forward_train(params, cfg, mode, src=mb["srcid"], tgt=mb.get("tgtid"),
                                    acous_feats=mb.get("acous_feat"),
                                    acous_lens=mb.get("acouslen"), generator=g,
                                    is_training=is_training, ref_pick=True)
                total, losses = head_losses(cfg, mode, out, mb["srcid"], mb.get("tgtid"),
                                            inv_n, loss_coeff, eval_with_mask,
                                            normalise_loss, norms=mb if cut else None)
            with span("stjep.train.backward"):
                gs = torch.autograd.grad(total, ps, allow_unused=True)
                for acc, gr in zip(grads, gs):
                    if gr is not None:
                        acc.add_(gr)
        sums = {k: sums[k] + (v.detach().float() if torch.is_tensor(v) else v)
                for k, v in losses.items()}
    if cut:
        sums = _sum_over_processes(sums, grads)
    return sums, grads


def _sum_over_processes(sums: Dict, grads: List[torch.Tensor]) -> Dict:
    """The gradients (in place) and the losses summed over the processes in
    one all_reduce of a flat f32 bucket: the gradients in bridge.leaves
    order, then the losses. Returns the summed losses."""
    lead = grads[0].device
    keys = sorted(sums)
    bucket = torch.cat([g.reshape(-1).to(lead, torch.float32) for g in grads]
                       + [sums[k].reshape(1).to(lead) for k in keys])
    distributed.all_reduce_sum(bucket)
    parts = bucket.split([g.numel() for g in grads] + [1] * len(keys))
    for g, part in zip(grads, parts):
        g.copy_(part.view(g.shape))
    return {k: part[0] for k, part in zip(keys, parts[len(grads):])}


def own_rows(B: int) -> Optional[slice]:
    """This process's rows of a minibatch of B (mesh.process_rows) under
    the installed kernel mesh; without one, each process counts as one
    device."""
    mesh = kernel_mesh()
    if mesh is not None:
        return mesh.process_rows(B)
    P = distributed.world_size()
    return process_rows(B, P, P, distributed.rank())


def step_grads(cfg: ModelConfig, mode: str, params: Dict, minibatches: List[Dict],
               generator: torch.Generator, device="cuda", **kw):
    """make_train_step's gradient half: the minibatches moved to `device`
    (params must lie there) and compute_grads in training mode (`kw` its
    options). Under a process group, where every minibatch's rows divide
    by the global data axis, each rank takes its rows of each minibatch,
    which carry the whole minibatch's normalisers, and the losses and
    gradients come summed over the ranks; elsewhere every rank runs the
    whole minibatches, with no sum."""
    device = check_params_device(params, device)
    rows = [own_rows(mb["srcid"].shape[0]) for mb in minibatches]
    cut = all(r is not None for r in rows)
    mbs = []
    for mb, r in zip(minibatches, rows):
        if cut:
            mb = {**{k: v[r] for k, v in mb.items()},
                  **head_norms(mb["srcid"], mb.get("tgtid"), kw.get("eval_with_mask", True))}
        mbs.append({k: v.to(device) for k, v in mb.items()})
    return compute_grads(cfg, mode, params, mbs, generator, cut=cut, **kw)


def make_train_step(cfg: ModelConfig, mode: str, optimizer: Optimizer,
                    device="cuda"):
    """The step `step(params, opt_state, minibatches, generator, lr) ->
    (params, opt_state, losses)`: step_grads, then the optimizer's clip
    and Adam with lr, updating params in place (the JAX step donates and
    returns them). It runs on `device`, the card unless the caller asks
    for the CPU: the minibatches move there, and params must already lie
    there (ValueError otherwise). Under a process group each rank passes
    the whole minibatches and steps on its rows of them (step_grads).
    A step is the span `stjep.train.step`."""
    _check_trainable(cfg, mode)
    device = torch.device(device)

    def step(params: Dict, opt_state, minibatches: List[Dict],
             generator: torch.Generator, lr: float):
        with span("stjep.train.step"):
            losses, grads = step_grads(cfg, mode, params, minibatches, generator, device)
            optimizer.update(grads, set_lr(opt_state, lr))
        return params, opt_state, losses

    return step


class _ScalarWriter:
    """Scalars as JSON lines in <expt>/scalars.jsonl (the JAX trainer's
    file; it also feeds TensorBoard when that imports, which the port
    leaves out)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        # rank 0 alone writes under a process group
        self._jsonl = (open(os.path.join(log_dir, "scalars.jsonl"), "a")
                       if distributed.is_primary() else None)

    def add_scalar(self, tag: str, value, global_step: int = 0):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(global_step)}) + "\n")
        self._jsonl.flush()


def _float_dtype(params: Dict) -> torch.dtype:
    """The params' compute dtype: their first floating leaf's."""
    for t in leaves(params):
        if t.is_floating_point():
            return t.dtype
    return torch.float32


class Trainer:
    """Base trainer (ref: trainer/trainer_base.py:23-443; JAX
    stjep_tpu/train/trainer.py Trainer), with JAX's constructor arguments,
    `device`, where the run goes (the card unless the caller passes
    "cpu"), and `devices`, the mesh's (module docstring)."""

    MODE = "ASR"  # overridden by subclasses
    DATA_KEY = "asr"

    def __init__(self, expt_dir="experiment", load_dir=None, load_mode="null",
                 load_freeze=False, checkpoint_every=100, print_every=100,
                 batch_size=256, use_gpu=False, gpu_id=0, learning_rate=0.00001,
                 learning_rate_init=0.0005, lr_warmup_steps=16000,
                 max_grad_norm=1.0, eval_with_mask=True, max_count_no_improve=2,
                 max_count_num_rollback=2, keep_num=1, normalise_loss=True,
                 loss_coeff=None, minibatch_partition=1, seed=333,
                 acous_bucket=256, n_model=1, feat_dtype=None,
                 device_cache="auto", train_window=1, device="cuda", devices=None):
        self.n_model = max(1, int(n_model or 1))
        self.checkpoint_every = checkpoint_every
        self.print_every = print_every
        self.loss_coeff = loss_coeff or {"nll_asr": 1.0, "nll_mt": 1.0, "nll_st": 1.0}
        self.learning_rate = learning_rate
        self.learning_rate_init = learning_rate_init
        self.lr_warmup_steps = lr_warmup_steps
        if self.lr_warmup_steps <= 0 and learning_rate != learning_rate_init:
            raise ValueError("without a warmup (lr_warmup_steps <= 0) learning_rate "
                             "must equal learning_rate_init")
        self.max_grad_norm = max_grad_norm
        self.eval_with_mask = eval_with_mask
        self.max_count_no_improve = max_count_no_improve
        self.max_count_num_rollback = max_count_num_rollback
        self.keep_num = keep_num
        self.normalise_loss = normalise_loss
        if not os.path.isabs(expt_dir):
            expt_dir = os.path.join(os.getcwd(), expt_dir)
        self.expt_dir = expt_dir
        os.makedirs(self.expt_dir, exist_ok=True)
        self.load_dir = load_dir
        self.load_mode = load_mode or "null"
        self.load_freeze = bool(load_freeze)
        self.logger = logging.getLogger(__name__)
        self.writer = _ScalarWriter(self.expt_dir)
        self.minibatch_partition = max(1, minibatch_partition)
        self.batch_size = batch_size
        self.minibatch_size = max(1, int(self.batch_size / self.minibatch_partition))
        self.seed = seed
        self.acous_bucket = acous_bucket
        self._root_gen = torch.Generator().manual_seed(int(seed or 0))
        self._lr_curr = learning_rate_init
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: the trainer runs on the "
                               "card unless the caller passes device='cpu'")
        if devices is None:  # JAX's jax.local_devices(): every visible card, the
            # current one a rank under a process group
            devices = ([self.device] if self.device.type != "cuda"
                       else [torch.device("cuda", torch.cuda.current_device())]
                       if distributed.world_size() > 1
                       else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        self.devices = [torch.device(d) for d in devices]
        if any(d.type != self.device.type for d in self.devices):
            raise ValueError(f"mesh devices {self.devices} are not all {self.device.type}")
        self._mesh: Optional[Mesh] = None
        self._rows: Optional[slice] = None  # this process's rows of a minibatch
        # host staging dtype of the acoustic features: None keeps the
        # loader's float32; "bfloat16" halves the host-to-device bytes;
        # "int8" quarters them (per-utterance scales, dequantized on the
        # device into the compute dtype, data/device_cache.py)
        if feat_dtype in ("bfloat16", torch.bfloat16):
            feat_dtype = "bfloat16"
        elif feat_dtype in ("float32", torch.float32, np.float32):
            feat_dtype = None
        elif feat_dtype not in (None, "int8"):
            raise ValueError(f"feat_dtype {feat_dtype!r}: float32, bfloat16 or int8")
        self.feat_dtype = feat_dtype
        if isinstance(device_cache, str):
            dc = device_cache.strip().lower()
            if dc not in ("auto", "true", "false"):
                raise ValueError(f"device_cache {device_cache!r}: auto, True or False")
            device_cache = "auto" if dc == "auto" else dc == "true"
        self.device_cache = device_cache
        self.train_window = max(1, int(train_window))
        self._feat_caches: Dict = {}
        self._feat_cache = None
        self._compute_dtype = torch.float32  # set from params in train()
        self._tx: Optional[Optimizer] = None
        self.steps_run = 0  # train steps run by this trainer (a test hook)
        self.windows_run = 0  # windows of train_window steps among them
        self.start = (1, 0)  # (epoch, step) the run started from
        # host seconds of the epoch loops (loader and staging included), of
        # the dev evals and checkpoint-on-improve writes inside them, and the
        # dev utterances evaluated; the device is synchronised at each edge;
        # each timed phase is the span stjep.train.loop, .eval or .save too
        self.timing = {"loop_s": 0.0, "eval_s": 0.0, "save_s": 0.0, "eval_utts": 0}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- batches

    def _device_batch(self, item: Dict[str, np.ndarray], pad_to: int):
        """Pad the macro batch to a fixed row count and reshape to
        [n_mini, mini, ...]. Padded rows are all-PAD -> masked out of every
        loss; the divisor is the number of minibatches with real rows, as
        the reference's ragged last minibatch gives it (ref:
        trainer_asr.py:215-216)."""
        B = item["srcid"].shape[0]
        mini = self.minibatch_size
        n_rows = ((max(pad_to, B) + mini - 1) // mini) * mini
        out = {}
        for k, v in item.items():
            pad_width = [(0, n_rows - B)] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(v, pad_width) if B < n_rows else v
        if "acous_feat" in out:
            # bucket the time axis, so batches of nearby lengths share a shape
            v = out["acous_feat"]
            T = bucket_length(v.shape[1], self.acous_bucket)
            if T > v.shape[1]:
                out["acous_feat"] = np.pad(v, [(0, 0), (0, T - v.shape[1]), (0, 0)])
        n_mini = n_rows // mini
        for k, v in out.items():
            out[k] = v.reshape((n_mini, mini) + v.shape[1:])
        n_real = B // mini + int(B % mini > 0)
        return out, float(n_real)

    def _resolve_device_cache(self, train_set, log) -> bool:
        """Whether this dataset's features live on the device: False ->
        never; True -> always; "auto" -> when the corpus's estimated bytes
        fit the free device-memory budget (decided once per dataset and
        logged)."""
        has_acous = (bool(getattr(train_set, "train_acous_flis", []))
                     and any(train_set.train_acous_flis))
        if not has_acous or self.device_cache is False:
            return False
        if self.device_cache is True:
            return True
        key = ("auto", id(train_set))
        if key in self._feat_caches:
            return self._feat_caches[key]
        need = estimate_corpus_bytes(train_set, self.acous_bucket,
                                     self.feat_dtype or np.float32)
        budget = hbm_cache_budget(device=self.device)
        fits = 0 < need <= budget
        log.info("device cache AUTO: corpus needs %.1f MB, device budget %.1f MB "
                 "-> %s (override with --device_cache True/False)",
                 need / 2 ** 20, budget / 2 ** 20,
                 "ENABLED (features stay on the device across epochs)"
                 if fits else "DISABLED (per-step feature staging)")
        self._feat_caches[key] = fits
        return fits

    def _host_macro(self, item):
        """Host half of batch staging: pad/reshape the macro batch, cut it
        to this process's rows (module docstring), resolve cache rows,
        quantize features. Returns (macro, n_real, t_bucket):
        t_bucket is None except on the device-cache path, where the macro
        carries row indices and the step gathers them, cut to t_bucket."""
        t_bucket = None
        if "_flis" in item:  # device-cache path (iter_batches(with_acous=False))
            flis = item.pop("_flis")
            item["acous_idx"] = self._feat_cache.rows(flis)
            t_bucket = bucket_length(
                int(round_up8(max(1, int(item["acouslen"].max())))), self.acous_bucket)
        macro, n_real = self._device_batch(item, self.batch_size)
        if self._rows is not None:  # this process's rows, the whole minibatches' normalisers
            norms = head_norms(macro["srcid"], macro.get("tgtid"), self.eval_with_mask)
            macro = {**{k: v[:, self._rows] for k, v in macro.items()}, **norms}
        if self.feat_dtype == "int8" and "acous_feat" in macro:
            qd = quantize_batch(macro["acous_feat"], np.float32)
            macro["acous_feat"] = qd["q"]
            macro["acous_scale"] = qd["scale"]
        return macro, n_real, t_bucket

    def _place_macro(self, staged):
        """Device half of batch staging: one pinned, non-blocking copy a
        leaf (bf16 staging casts the features on the host first). On a mesh
        the macro goes whole to its first device: the data-shard wrappers of
        parallel/spmd.py make the only cut, per kernel call."""
        macro, n_real, t_bucket = staged
        placed = to_device({k: v for k, v in macro.items() if k != "acous_feat"},
                           self.device)
        if "acous_feat" in macro:
            feat = torch.from_numpy(np.ascontiguousarray(macro["acous_feat"]))
            if self.feat_dtype == "bfloat16":
                feat = feat.to(torch.bfloat16)
            if self.device.type == "cuda":
                feat = feat.pin_memory().to(self.device, non_blocking=True)
            placed["acous_feat"] = feat
        return placed, n_real, t_bucket

    def _stage_batch(self, item):
        """Pad/reshape the macro batch and place it on the device (run in
        the prefetch thread, so the copy overlaps the previous step)."""
        return self._place_macro(self._host_macro(item))

    # -------------------------------------------------------------- step

    def _minibatch(self, mb: Dict[str, torch.Tensor], t_bucket: Optional[int]):
        """A minibatch of the placed macro, its features assembled on the
        device: gathered from the resident cache, or dequantized."""
        mb = dict(mb)
        if "acous_idx" in mb:
            mb["acous_feat"] = gather_features(self._feat_cache.arrays,
                                               mb.pop("acous_idx"), t_bucket,
                                               self._compute_dtype)
        elif "acous_scale" in mb:
            mb["acous_feat"] = dequantize(mb["acous_feat"], mb.pop("acous_scale"),
                                          self._compute_dtype)
        return mb

    def _grads(self, cfg, params, macro, t_bucket, generator, inv_n):
        """The losses and the gradients (in bridge.leaves(params) order) of
        a placed macro batch [n_mini, mini, ...], summed over the
        minibatches."""
        n_mini = macro["srcid"].shape[0]
        mbs = [self._minibatch({k: v[i] for k, v in macro.items()}, t_bucket)
               for i in range(n_mini)]
        return compute_grads(
            cfg, self.MODE, params, mbs, generator, inv_n=inv_n,
            loss_coeff=self.loss_coeff, eval_with_mask=self.eval_with_mask,
            normalise_loss=self.normalise_loss, cut=self._rows is not None)

    def _step(self, cfg, params, opt_state, macro, t_bucket, generator, lr, inv_n):
        """One train step on a placed macro batch: `_grads`, then clip and
        Adam in place (the span `stjep.train.step`). Returns the losses as
        device scalars."""
        with span("stjep.train.step"):
            losses, grads = self._grads(cfg, params, macro, t_bucket, generator, inv_n)
            self._tx.update(grads, set_lr(opt_state, lr))
        self.steps_run += 1
        return losses

    def _train_batch(self, cfg, params, opt_state, item, step):
        # item: a raw host batch, or a staged (macro, n_real, t_bucket)
        macro, n_real, t_bucket = item if isinstance(item, tuple) else self._stage_batch(item)
        self._root_gen, k = split(self._root_gen)
        lr = self._current_lr(step)
        # the losses stay device scalars: the epoch loop drains them once
        # per print window, never per step
        losses = self._step(cfg, params, opt_state, macro, t_bucket, k, lr, 1.0 / n_real)
        self._last_losses_dev = losses
        return params, opt_state, losses

    def _window_stream(self, raw_iter, step0, total_steps, window):
        """Group the epoch's raw batches into K-step windows: yields staged
        singles (macro, n_real, t_bucket) or windows, lists of K of them. A
        window may only cover steps with no print/checkpoint boundary
        strictly inside it (its LAST step may sit on one), and batches whose
        time bucket differs from the pending window's flush as singles (JAX
        `_window_stream`). Each step is staged on its own: a stacked copy of
        a window's macros measured no faster (PERF.md section 6)."""
        bounds = [b for b in (self.print_every, self.checkpoint_every) if b and b > 0]

        def boundary_dist(s):
            d = min((b - (s % b)) for b in bounds) if bounds else window
            if total_steps > s:
                d = min(d, total_steps - s)
            return d

        step = step0
        pending: List = []
        for it in raw_iter:
            pending.append(self._host_macro(it))
            if pending[0][2] != pending[-1][2]:  # bucket changed: drain
                while len(pending) > 1:
                    step += 1
                    yield self._place_macro(pending.pop(0))
            while len(pending) >= window:
                if boundary_dist(step) >= window:
                    step += window
                    yield [self._place_macro(s) for s in pending[:window]]
                    pending = pending[window:]
                else:
                    step += 1
                    yield self._place_macro(pending.pop(0))
        for s in pending:
            step += 1
            yield self._place_macro(s)

    def _last_losses(self) -> Dict:
        """Most recent train step's loss dict; a test hook."""
        return getattr(self, "_last_losses_dev", {})

    def _current_lr(self, step: int) -> float:
        # warmup_steps <= 0 deactivates the scheduler entirely, so the
        # rollback LR-halving persists (ref: trainer_base.py:141-143)
        if self.lr_warmup_steps > 0:
            lr = float(reference_lr(step, self.learning_rate_init, self.learning_rate,
                                    self.lr_warmup_steps))
        else:
            lr = self._lr_curr
        self._lr_curr = lr
        return lr

    # --------------------------------------------------------------- eval

    def _nll_picked_np(self, picked, mask, coeff=1.0):
        """Masked NLL from per-token reference log-probs."""
        p = np.asarray(picked).reshape(-1)
        m = np.asarray(mask).reshape(-1)
        s = -(p * m).sum()
        if self.normalise_loss:
            s = s / max(m.sum(), 1)
        return coeff * s

    def _evaluate_batches(self, cfg, params, dataset):
        """Free-running dev evaluation on forward_eval with refs (ref:
        trainer_*.py:_evaluate_batches). The eval kernels are f32: bf16
        params are evaluated through an f32 copy."""
        mode = self.MODE
        if self._mesh is not None:  # forward_eval cuts its own TP shards
            params = gather_params(params, self._mesh.lead)
        if _float_dtype(params) != torch.float32:
            params = _cast_tree(params, torch.float32)
        resloss_en = resloss_de = 0.0
        resnorm = 0
        match_en = total_en = match_de = total_de = 0
        hyp_en, ref_en, hyp_de, ref_de = [], [], [], []
        out_count = 0
        for item in dataset.iter_batches():
            B = item["srcid"].shape[0]
            for st in range(0, B, self.minibatch_size):
                ed = min(st + self.minibatch_size, B)
                kwargs = {}
                if "acous_feat" in item:
                    alen = int(round_up8(max(1, int(max(item["acouslen"][st:ed])))))
                    alen = bucket_length(alen, self.acous_bucket)
                    v = item["acous_feat"][st:ed]
                    if alen > v.shape[1]:
                        v = np.pad(v, [(0, 0), (0, alen - v.shape[1]), (0, 0)])
                    kwargs["acous_feats"] = torch.from_numpy(np.ascontiguousarray(v[:, :alen]))
                    kwargs["acous_lens"] = torch.from_numpy(item["acouslen"][st:ed])
                if mode in ("MT",):
                    kwargs["src"] = torch.from_numpy(item["srcid"][st:ed])
                src_ids = item["srcid"][st:ed]
                if "ASR" in mode:
                    kwargs["ref_src"] = torch.from_numpy(src_ids)
                if mode == "MT" or "ST" in mode:
                    kwargs["ref_tgt"] = torch.from_numpy(item["tgtid"][st:ed])
                out = forward_eval(params, cfg, mode, device=self.device, **kwargs)
                out = {k: v.cpu().numpy() for k, v in out.items()
                       if k.startswith(("preds_", "picked_"))}

                npm_src = src_ids != PAD
                if "ASR" in mode:
                    preds = out["preds_asr"]
                    resloss_en += self._nll_picked_np(out["picked_asr"], npm_src[:, 1:])
                    m = npm_src[:, 1:]
                    match_en += int(((preds == src_ids[:, 1:]) & m).sum())
                    total_en += int(m.sum())
                    out_count = self._print_sample(out_count, src_ids, dataset.src_id2word,
                                                   preds, "-asr")
                    hyp_en, ref_en = add2corpus(preds, src_ids, dataset.src_id2word,
                                                hyp_en, ref_en, use_type="word")
                if mode == "MT" or "ST" in mode:
                    key = "mt" if mode == "MT" else "st"
                    coeff = self.loss_coeff[f"nll_{key}"]
                    tgt_ids = item["tgtid"][st:ed]
                    npm_tgt = tgt_ids != PAD
                    preds = out[f"preds_{key}"][:, 1:]
                    L = tgt_ids.shape[1] - 1
                    resloss_de += self._nll_picked_np(out[f"picked_{key}"], npm_tgt[:, 1:],
                                                      coeff=coeff)
                    m = npm_tgt[:, 1:]
                    match_de += int(((preds[:, :L] == tgt_ids[:, 1:]) & m).sum())
                    total_de += int(m.sum())
                    out_count = self._print_sample(out_count, tgt_ids, dataset.tgt_id2word,
                                                   preds, f"-{key}")
                    hyp_de, ref_de = add2corpus(preds, tgt_ids, dataset.tgt_id2word,
                                                hyp_de, ref_de, use_type=dataset.use_type)
                resnorm += 1

        losses = {"nll_loss_en": resloss_en / max(resnorm, 1),
                  "nll_loss_de": resloss_de / max(resnorm, 1)}
        metrics = {
            "accuracy_en": match_en / total_en if total_en else 0.0,
            "bleu_en": corpus_bleu(hyp_en, ref_en) if hyp_en else 0.0,
            "accuracy_de": match_de / total_de if total_de else 0.0,
            "bleu_de": corpus_bleu(hyp_de, ref_de) if hyp_de else 0.0,
        }
        return losses, metrics

    def _print_sample(self, out_count, ids, id2word, seqlist, tail=""):
        """First-3 REF/HYP printing (ref: trainer_base.py:108-118)."""
        if out_count < 3 and len(ids) > 0:
            ref_words = _misc._convert_to_words_batchfirst(ids[:, 1:], id2word)
            hyp_words = _misc._convert_to_words_batchfirst(seqlist, id2word)
            sys.stdout.write("REF{}: {}\n".format(tail, " ".join(ref_words[0])))
            sys.stdout.write("HYP{}: {}\n".format(tail, " ".join(hyp_words[0])))
            out_count += 1
        return out_count

    # ------------------------------------------------------------- train

    def train(self, train_sets, model, num_epochs=5, optimizer=None,
              dev_sets=None, grab_memory=False):
        """Main entry (ref: trainer_base.py:169-443). model: (cfg, params)
        with params on the trainer's device. Returns (cfg, params), params
        gathered on a mesh (`_final_params` keeps the training layout that
        `_final_opt_state` is keyed by). The kernel mesh installed before
        the call is installed again after it."""
        cfg, params = model
        before = kernel_mesh()
        try:
            params, opt_state, start_epoch, step = self.setup(params, cfg)
            self._train_epoches(train_sets, cfg, params, opt_state, num_epochs,
                                start_epoch, step, dev_sets=dev_sets)
        finally:
            set_kernel_mesh(before)
        if self._mesh is not None:
            return cfg, gather_params(self._final_params)
        return cfg, self._final_params

    def _setup_mesh(self):
        """Build and install the (data, model) mesh when more than one
        device is given, n_model > 1 or the process group has more than
        one rank (JAX :386-405); one device and n_model 1 keep no mesh.
        make_mesh degrades a shape that does not fit the devices to pure
        data parallelism, with JAX's warning."""
        if self._mesh is not None:
            return
        if len(self.devices) > 1 or self.n_model > 1 or distributed.world_size() > 1:
            self._mesh = make_mesh(n_model=self.n_model, devices=self.devices)
            self.device = self._mesh.lead  # where batches, joins and dev eval go
            self.logger.info("device mesh: %s", self._mesh.shape)
            set_kernel_mesh(self._mesh)

    def _place(self, params, cfg):
        """The training layout of params on the mesh (no-op without one):
        after every init, load mode and resume (JAX :407-415); a rollback
        assigns into it in place. The optimizer state is built after it, on
        the placed leaves."""
        if self._mesh is None:
            return params
        return place_params(params, self._mesh, cfg.num_heads)

    def setup(self, params, cfg):
        """The load mode applied to params (on the trainer's device) of the
        model `cfg`: the optimizer with its freezing mask, and for
        resume/restart the checkpoint's params (in place) and optimizer
        state. On a mesh (installed here) params then take the training
        layout, and Adam is built on it. Returns (params, opt_state,
        start_epoch, start_step)."""
        check_params_device(params, self.device)
        self._setup_mesh()
        self._rows = self._mesh.process_rows(self.minibatch_size) if self._mesh else None
        start_epoch, step = 1, 0
        self._compute_dtype = _float_dtype(params)
        if "resume" in self.load_mode or "restart" in self.load_mode:
            self.logger.info("resuming %s ...", self.load_dir)
            mask = trainable_mask(params, lambda n: False)
            if self.load_mode == "ASR-resume" and self.load_freeze:
                mask = trainable_mask(params, lambda n: n.startswith("las."))
            self._tx = make_optimizer(self.max_grad_norm, mask)
            ckpt = Checkpoint.load(self.load_dir, params_template=params,
                                   with_opt_state=True)
            _assign(params, ckpt.params)
            params = self._place(params, cfg)
            opt_state = self._tx.init(params)
            if ckpt.opt_state is not None:
                self._tx.load_state_tree(params, opt_state, ckpt.opt_state)
            if "resume" in self.load_mode:
                start_epoch, step = ckpt.epoch, ckpt.step
        else:
            loaded = None
            if self.load_dir is not None:
                self.logger.info("loading %s (mode=%s) ...", self.load_dir, self.load_mode)
                loaded = Checkpoint.load(self.load_dir).params
            params, mask = apply_load_mode(params, loaded, self.load_mode,
                                           self.load_freeze, self.logger)
            self._tx = make_optimizer(self.max_grad_norm, mask)
            params = self._place(params, cfg)
            opt_state = self._tx.init(params)
        self.start = (start_epoch, step)
        return params, opt_state, start_epoch, step

    def _save(self, cfg, params, opt_state, epoch, step, train_set, epoch_dir=False):
        """A checkpoint of the gathered params and optax's unsharded state
        tree: the same bytes whatever the mesh."""
        ckpt = Checkpoint(params=gather_params(params) if self._mesh is not None else params,
                          opt_state=self._tx.state_tree(params, opt_state),
                          epoch=epoch, step=step, input_vocab=train_set.vocab_src,
                          output_vocab=train_set.vocab_tgt,
                          model_config=dataclasses.asdict(cfg))
        saved = ckpt.save_epoch(self.expt_dir, epoch) if epoch_dir else ckpt.save(self.expt_dir)
        self.logger.info("saving at %s ...", saved)
        return ckpt

    def _train_epoches(self, train_sets, cfg, params, opt_state, n_epochs,
                       start_epoch, start_step, dev_sets=None):
        train_set = train_sets[self.DATA_KEY]
        dev_set = (dev_sets or {}).get(self.DATA_KEY)
        log = self.logger

        loss_window: List[Dict] = []  # device scalars, drained at print time
        step, step_elapsed = start_step, 0
        prev_acc = prev_bleu = 0.0
        count_no_improve = count_num_rollback = 0
        ckpt = None
        early_stop = False

        for epoch in range(start_epoch, n_epochs + 1):
            if early_stop:
                break
            lr = self._current_lr(max(step, 1))
            log.info("epoch:%d lr: %s", epoch, lr)
            log.info("--- construct train set ---")
            train_set.construct_batches(is_train=True)
            if dev_set is not None:
                dev_set.construct_batches(is_train=False)

            steps_per_epoch = len(train_set)
            total_steps = steps_per_epoch * n_epochs
            log.info("steps_per_epoch %d", steps_per_epoch)
            _, mem_mb, _ = get_memory_alloc()
            log.info("Memory used: %.2f MB", mem_mb)
            self.writer.add_scalar("Memory_MB", round(mem_mb, 2), global_step=step)

            use_cache = self._resolve_device_cache(train_set, log)
            if use_cache and id(train_set) not in self._feat_caches:
                try:
                    self._feat_caches[id(train_set)] = DeviceFeatureCache.build(
                        train_set, self.acous_bucket, self.feat_dtype or np.float32,
                        device=self.device, logger=log)
                except (torch.cuda.OutOfMemoryError, RuntimeError, MemoryError) as e:
                    # the upload failed (memory the estimate missed): stage per
                    # step rather than end the run, as JAX does (:843-856)
                    log.warning("device cache: upload FAILED (%s) — falling back "
                                "to per-step feature staging", e)
                    self._feat_caches[id(train_set)] = None
            self._feat_cache = self._feat_caches.get(id(train_set)) if use_cache else None
            use_cache = self._feat_cache is not None

            # staging (pad + pinned copy) runs in the prefetch thread; with
            # the cache the iterator skips the np.load/CMVN and stages row
            # indices, and K steps may run as one window
            win = self.train_window if use_cache else 1
            raw_iter = train_set.iter_batches(with_acous=not use_cache)
            if win > 1:
                staged_iter = self._window_stream(raw_iter, step, total_steps, win)
            else:
                staged_iter = (self._stage_batch(it) for it in raw_iter)
            self._sync()
            t_loop = time.perf_counter()
            with span("stjep.train.loop"):
                for item in host_prefetch(staged_iter, size=2):
                    # a window's steps run back to back: no print or checkpoint
                    # boundary lies strictly inside it
                    self.windows_run += isinstance(item, list)
                    for staged in item if isinstance(item, list) else [item]:
                        step += 1
                        step_elapsed += 1
                        if step_elapsed <= 2:
                            log.info("step %d (the first steps build the kernels)", step)
                        params, opt_state, losses = self._train_batch(
                            cfg, params, opt_state, staged, step)
                        loss_window.append(losses)
                        if len(loss_window) >= 1024:
                            # bound the window: pre-reduce on the device, no readback
                            loss_window = [{k: torch.stack([w[k] for w in loss_window]).sum()
                                            for k in loss_window[0]}]

                    if step % self.print_every == 0 and step_elapsed > self.print_every:
                        # one drain a print window (the reference divides by
                        # print_every however many steps accumulated,
                        # trainer_asr.py:367-373)
                        avg_en, avg_de = (
                            float(torch.stack([w[k] for w in loss_window]).sum()) / self.print_every
                            for k in ("nll_loss_en", "nll_loss_de"))
                        loss_window = []
                        log.info("Progress: %d%%, Train nlll_de: %.4f, nlll_en: %.4f",
                                 step / total_steps * 100, avg_de, avg_en)
                        self.writer.add_scalar("train_loss_de", avg_de, global_step=step)
                        self.writer.add_scalar("train_loss_en", avg_en, global_step=step)

                    if step % self.checkpoint_every == 0 or step == total_steps:
                        if dev_set is None:
                            continue
                        log.info("evaluating at step %d ...", step)
                        self._sync()
                        t0 = time.perf_counter()
                        with span("stjep.train.eval"):
                            losses_d, metrics = _primary_numbers(
                                *self._evaluate_batches(cfg, params, dev_set))
                        self.timing["eval_s"] += time.perf_counter() - t0
                        self.timing["eval_utts"] += dev_set.num_training_sentences
                        for tag in ("nll_loss_en", "nll_loss_de"):
                            self.writer.add_scalar("dev_" + tag, losses_d[tag], global_step=step)
                        for tag, v in metrics.items():
                            self.writer.add_scalar("dev_" + tag, v, global_step=step)
                        acc, bleu = self._ckpt_criterion(losses_d, metrics)
                        log.info("Progress: %d%%, Dev loss en: %.4f de: %.4f, "
                                 "acc: %.4f, bleu: %.4f", step / total_steps * 100,
                                 losses_d["nll_loss_en"], losses_d["nll_loss_de"], acc, bleu)

                        # save criterion (ref: trainer_asr.py:409)
                        if ((prev_acc < acc) and (bleu < 0.1)) or prev_bleu < bleu:
                            self._sync()
                            t0 = time.perf_counter()
                            with span("stjep.train.save"):
                                ckpt = self._save(cfg, params, opt_state, epoch, step, train_set)
                            self.timing["save_s"] += time.perf_counter() - t0
                            prev_acc, prev_bleu = acc, bleu
                            count_no_improve = count_num_rollback = 0
                        else:
                            count_no_improve += 1

                        if count_no_improve > self.max_count_no_improve:
                            if self.max_count_num_rollback == 0:
                                early_stop = True
                                break
                            self._rollback(params, opt_state, log, epoch, step)
                            count_no_improve = 0
                            count_num_rollback += 1

                        if count_num_rollback > self.max_count_num_rollback:
                            self._rollback(params, opt_state, log, epoch, step)
                            # halve the LR (ref: trainer_asr.py:472-477); with a
                            # warmup schedule the next step recomputes it
                            self._lr_curr *= 0.5
                            log.info("reducing lr ... step:%d - lr: %s", step, self._lr_curr)
                            if self._lr_curr <= 0.125 * self.learning_rate:
                                log.info("early stop ...")
                                early_stop = True
                                break
                            count_no_improve = count_num_rollback = 0

                        if ckpt is not None:
                            ckpt.rm_old(self.expt_dir, keep_num=self.keep_num)
                        log.info("n_no_improve %d, num_rollback %d", count_no_improve,
                                 count_num_rollback)
                self._sync()
            self.timing["loop_s"] += time.perf_counter() - t_loop
            if dev_set is None:  # the loop breaks only on a dev set's early stop
                ckpt = self._save(cfg, params, opt_state, epoch, step, train_set,
                                  epoch_dir=True)

        self._final_params = params
        self._final_opt_state = opt_state

    def _ckpt_criterion(self, losses, metrics):
        """ASR judges on EN stats; every other mode on DE
        (ref: trainer_asr.py:406-409 vs trainer_asr_st.py:486)."""
        if self.MODE == "ASR":
            return metrics["accuracy_en"], metrics["bleu_en"]
        return metrics["accuracy_de"], metrics["bleu_de"]

    def _rollback(self, params, opt_state, log, epoch, step):
        """Reload the latest checkpoint's params and optimizer state, in
        place (Adam holds the param tensors; on a mesh the slices take
        their cut of each loaded leaf, so the layout stays placed)."""
        latest = Checkpoint.get_latest_checkpoint(self.expt_dir)
        if latest is None:
            return
        log.info("epoch:%d step: %d - rolling back %s ...", epoch, step, latest)
        ckpt = Checkpoint.load(latest, params_template=gather_params(params)
                               if self._mesh is not None else params, with_opt_state=True)
        _assign(params, ckpt.params)
        if ckpt.opt_state is not None:
            self._tx.load_state_tree(params, opt_state, ckpt.opt_state)


def _primary_numbers(*dicts: Dict) -> tuple:
    """Dicts of numbers as rank 0 holds them, on every rank (themselves
    with one process): the dev eval's numbers every rank decides on."""
    if distributed.world_size() == 1:
        return dicts
    vals = torch.tensor([float(v) for d in dicts for v in d.values()], dtype=torch.float64)
    if not distributed.is_primary():
        vals.zero_()
    it = iter(distributed.all_reduce_sum(vals).tolist())
    return tuple({k: next(it) for k in d} for d in dicts)


def _cast_tree(tree, dtype):
    """A copy of a params tree with floating leaves in `dtype`."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    return tree.detach().to(dtype) if tree.is_floating_point() else tree


def _assign(params: Dict, values: Dict):
    """Copy a loaded tree of the unsharded structure into params' tensors,
    in place (cast to each leaf's dtype and device); a split leaf's slices
    (the mesh's training layout) take their cut of the loaded leaf."""
    with torch.no_grad():
        for (name, p), (_, v) in zip(logical_leaves(params), named_leaves(values), strict=True):
            if not isinstance(p, Shards):
                parts, cuts, shape = [p], [v], tuple(p.shape)
            else:
                parts, dim = list(p), shard_dim(name)
                widths = [x.shape[dim] for x in parts]
                shape = tuple(sum(widths) if i == dim else n
                              for i, n in enumerate(parts[0].shape))
                cuts = torch.split(torch.as_tensor(v), widths, dim)
            if tuple(v.shape) != shape:
                raise ValueError(f"checkpoint leaf {name} has shape {tuple(v.shape)}, "
                                 f"the model {shape}")
            for x, cut in zip(parts, cuts):
                x.copy_(cut)


class Trainer_ASR(Trainer):
    MODE = "ASR"
    DATA_KEY = "asr"


class Trainer_MT(Trainer):
    MODE = "MT"
    DATA_KEY = "mt"


class Trainer_ST(Trainer):
    MODE = "ST"
    DATA_KEY = "st"


class Trainer_ASR_ST(Trainer):
    MODE = "ASR_ST"
    DATA_KEY = "st"
