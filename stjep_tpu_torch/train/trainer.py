"""The train step (port of stjep_tpu/train/trainer.py `_head_losses` and
`_step_core`, as plain functions; the Trainer class, its epoch loop, the
data layer and train.py are not ported yet).

One step: per minibatch, the teacher-forced forward with ref_pick, the
masked NLL of each head and its gradient; the gradients are summed over the
minibatches (the JAX step's lax.scan), clipped and applied by Adam
(optim.py), in place. Modes ASR, MT and ASR_ST. ST alone trains through
the free-running LAS decoder, whose kernel (K2) has no backward, and the AE
modes through their own head: both raise NotImplementedError (ROADMAP
Queue A item 7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from stjep_tpu_torch.bridge import check_params_device, leaves
from stjep_tpu_torch.config import PAD, ModelConfig
from stjep_tpu_torch.models.seq2seq import forward_train
from stjep_tpu_torch.ops.losses import normalise
from stjep_tpu_torch.ops.transformer import split
from stjep_tpu_torch.train.optim import Optimizer, set_lr

MODES = ("ASR", "MT", "ASR_ST")
LOSS_COEFF = {"nll_asr": 1.0, "nll_mt": 1.0, "nll_st": 1.0}


def head_losses(cfg: ModelConfig, mode: str, out: Dict, srcid: torch.Tensor,
                tgtid: Optional[torch.Tensor], inv_n: float,
                loss_coeff: Optional[Dict] = None, eval_with_mask: bool = True,
                normalise_loss: bool = True):
    """Per-head masked NLL over the picked log-probs of forward_train
    (ref_pick=True), with the reference's normalise / coefficient / 1/n_mini
    scaling. Returns (total, {"nll_loss_en", "nll_loss_de"})."""
    coeffs = loss_coeff or LOSS_COEFF
    losses = {"nll_loss_en": 0.0, "nll_loss_de": 0.0}
    total = 0.0

    def head(picked, targets, coeff):
        mask = (targets != PAD).to(picked.dtype)
        if eval_with_mask:
            s, norm = -torch.sum(picked * mask), torch.sum(mask)
        else:
            s = -torch.sum(picked)
            norm = torch.tensor(float(targets.numel()), device=picked.device)
        loss = normalise(s, norm) if normalise_loss else s
        return loss * coeff * inv_n

    if "ASR" in mode:
        coeff = coeffs["nll_asr"] if mode == "ASR_ST" else 1.0
        losses["nll_loss_en"] = head(out["picked_asr"], srcid[:, 1:], coeff)
        total = total + losses["nll_loss_en"]
    if mode == "MT":
        losses["nll_loss_de"] = head(out["picked_mt"], tgtid[:, 1:], coeffs["nll_mt"])
        total = total + losses["nll_loss_de"]
    if "ST" in mode:
        losses["nll_loss_de"] = head(out["picked_st"], tgtid[:, 1:], coeffs["nll_st"])
        total = total + losses["nll_loss_de"]
    return total, losses


def _check_mode(mode: str):
    if mode not in MODES:
        raise NotImplementedError(
            f"train mode {mode!r} is not ported yet (ported: {', '.join(MODES)}); "
            "ST alone and the AE modes wait (ROADMAP Queue A item 7)")


def compute_grads(cfg: ModelConfig, mode: str, params: Dict,
                  minibatches: Sequence[Dict], generator: torch.Generator,
                  is_training: bool = True):
    """Summed losses and gradients over the minibatches, each loss scaled
    by 1 / len(minibatches). A minibatch holds srcid [B, Ls], and as the
    mode needs tgtid [B, Lt], acous_feat [B, T, C] and acouslen [B].
    is_training=False gives the deterministic step (no dropout, no
    SpecAugment) that holds one device against another. Returns (losses
    dict, grads in bridge.leaves(params) order)."""
    _check_mode(mode)
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    inv_n = 1.0 / len(minibatches)
    grads = [torch.zeros_like(p) for p in ps]
    sums = {"nll_loss_en": 0.0, "nll_loss_de": 0.0}
    for mb, g in zip(minibatches, split(generator, len(minibatches))):
        out = forward_train(params, cfg, mode, src=mb["srcid"], tgt=mb.get("tgtid"),
                            acous_feats=mb.get("acous_feat"),
                            acous_lens=mb.get("acouslen"), generator=g,
                            is_training=is_training, ref_pick=True)
        total, losses = head_losses(cfg, mode, out, mb["srcid"], mb.get("tgtid"),
                                    inv_n)
        gs = torch.autograd.grad(total, ps, allow_unused=True)
        for acc, gr in zip(grads, gs):
            if gr is not None:
                acc.add_(gr)
        sums = {k: sums[k] + (v.detach() if torch.is_tensor(v) else v)
                for k, v in losses.items()}
    return {k: torch.as_tensor(v).detach() for k, v in sums.items()}, grads


def make_train_step(cfg: ModelConfig, mode: str, optimizer: Optimizer,
                    device="cuda"):
    """The step `step(params, opt_state, minibatches, generator, lr) ->
    (params, opt_state, losses)`: compute_grads in training mode, then the
    optimizer's clip and Adam with lr, updating params in place (the JAX
    step donates and returns them). It runs on `device`, the card unless
    the caller asks for the CPU: the minibatches move there, and params
    must already lie there (ValueError otherwise)."""
    _check_mode(mode)
    device = torch.device(device)

    def step(params: Dict, opt_state, minibatches: List[Dict],
             generator: torch.Generator, lr: float):
        check_params_device(params, device)
        mbs = [{k: v.to(device) for k, v in mb.items()} for mb in minibatches]
        losses, grads = compute_grads(cfg, mode, params, mbs, generator)
        optimizer.update(grads, set_lr(opt_state, lr))
        return params, opt_state, losses

    return step
