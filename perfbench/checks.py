"""The comparisons that decide `correct`: what the timed path produced,
held to the plain reference (perfbench/reference/stjep.py) in float32 with
TF32 off, computed after the window on the same weights and inputs.

Decode (widest gaps over what the run holds; nats):
- asr_gap: the reference LAS, teacher forced on the program's ASR
  hypotheses of every pool batch the run served, at each step: how far
  the program's symbol's log-prob lies below the reference's best (K2's
  greedy choice).
- dyn_emb_err: over the sampled batches, the program's dynamic embeddings
  (the LAS pass's output that the source projection takes) against the
  reference's, teacher forced on the same hypotheses: max abs difference
  over max abs value.
- st_select_gap: the beam's choices, position by position, over the
  sampled batches. The reference follows the program's kept hypotheses:
  at position 1 from BOS alone, at each later position from the K the
  program kept at the one before (its transformer's memory built from the
  program's ASR hypotheses and the reference's own dynamic embeddings).
  It scores every extension of those parents by the parent's summed
  log-prob plus the next token's, and ranks the K x V candidates. The
  program's kept K, each matched to the parent it extends, should be the
  reference's top K, and the served row (slot 0 after the last position)
  its best candidate there. The number is the widest gap, rank by rank,
  by which a kept choice lies below the reference's choice at that rank.
  A hypothesis that extends no parent, or one kept twice, reads `MISS`.
- st_score_err: |the beam's kept score - the reference's summed log-probs
  of that hypothesis|, over every kept hypothesis at every position and
  the served row.
The ST head's EOS column is held at 0 by the decode entry, so no beam ends
early and a kept score is the sum of its tokens' log-probs (the reference
model's eos, length and normalisation bookkeeping by slot never acts).

Training (the program's first `check_steps` steps, run as the window runs
them, dropout and SpecAugment on; the reference follows them with the
same draws; relative numbers):
- loss_err: each step's head losses against the reference's;
- grad_err: the first gradient as Adam got it (its first moment after one
  step / (1 - beta1)), each leaf's norm against the reference's clipped
  gradient's, by the worst leaf, over max(the leaf's norm, the median
  leaf's);
- change_err: the parameters' change over the steps the same way, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (round-off alone moves them under Adam).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.reference import stjep as ref

NUMBERS = ("asr_gap", "dyn_emb_err", "st_select_gap", "st_score_err")
MISS = 1e3  # the gap read where a kept hypothesis is no candidate of the reference's


def las_lengths(hyps: torch.Tensor, L: int) -> torch.Tensor:
    return ref.lengths_from_symbols(hyps, L)


def _bos(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(t[:, :1], ref.BOS), t], dim=1)


@torch.no_grad()
def las_logps(model: Dict, params: Dict, feats: torch.Tensor, lens: torch.Tensor,
              hyps: torch.Tensor, tf32: bool = False):
    """The reference LAS teacher forced on hyps [B, Ls-1]: (dynamic
    embeddings [B, Ls-1, D], log-probs [B, Ls-1, Ve])."""
    ref.precise(tf32)
    try:
        acous, _ = ref.las_encoder(params["las"]["encoder"], model, feats, lens)
        dyn, logits = ref.las_decoder(params["las"]["decoder"], model, acous, lens,
                                      _bos(hyps.long()))
        return dyn, torch.log_softmax(logits, dim=-1)
    finally:
        ref.precise(False)


def asr_gap(las: torch.Tensor, hyps: torch.Tensor, chosen: Optional[torch.Tensor] = None):
    """How far the chosen symbols (the program's hyps, or a control's)
    lie below the reference's best, widest over the steps."""
    chosen = hyps.long() if chosen is None else chosen
    return float((las.max(-1).values - las.gather(-1, chosen[..., None])[..., 0]).max())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want).abs().max() / want.abs().max())


@torch.no_grad()
def st_memory(model: Dict, params: Dict, hyps: torch.Tensor, dyn: torch.Tensor,
              tf32: bool = False):
    ref.precise(tf32)
    try:
        return ref.st_memory(params, model, hyps.long(), dyn,
                             las_lengths(hyps, model["max_seq_len_src"]))
    finally:
        ref.precise(False)


@torch.no_grad()
def next_logps(model: Dict, params: Dict, tokens: torch.Tensor, memory: torch.Tensor,
               key_mask: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[B, P, V]: the reference's log-probs of the next token after each of
    the P hypotheses tokens [B, P, j] (BOS first) of a batch row, over that
    row's memory."""
    B, P, j = tokens.shape
    ref.precise(tf32)
    try:
        logits = ref.tf_decoder_logits(params, model, tokens.reshape(B * P, j).long(),
                                       memory.repeat_interleave(P, 0),
                                       key_mask.repeat_interleave(P, 0))[:, -1]
        return torch.log_softmax(logits, dim=-1).view(B, P, -1)
    finally:
        ref.precise(False)


def _rank_gap(cand: torch.Tensor, picked: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Rank by rank, how far the picked candidates' scores [B, n] lie below
    the best n of cand [B, N]; a pick that is no candidate (ok False)
    reads MISS."""
    n = picked.shape[1]
    best = cand.topk(n, dim=-1).values
    floor = best[:, -1:] - MISS
    got = torch.where(ok, picked, floor).sort(dim=-1, descending=True).values
    return (best - got).clamp(min=0).max()


def _match(kept: torch.Tensor, parents: torch.Tensor, V: int):
    """Each kept hypothesis [B, n, j+1] as a candidate of the parents
    [B, P, j]: (flat index parent * V + token [B, n], found [B, n]: it
    extends a parent and no earlier slot of its row holds it)."""
    j = parents.shape[2]
    same = (kept[:, :, None, :j] == parents[:, None, :, :]).all(-1)  # [B, n, P]
    flat = same.int().argmax(-1) * V + kept[:, :, j].long()
    first = torch.ones_like(flat, dtype=torch.bool)
    for s in range(1, flat.shape[1]):
        first[:, s] = (flat[:, :s] != flat[:, s:s + 1]).all(-1)
    return flat, same.any(-1) & first & (kept[:, :, j] >= 0) & (kept[:, :, j] < V)


@torch.no_grad()
def beam_numbers(model: Dict, params: Dict, memory, control_memory, steps: List[Tuple],
                 served: torch.Tensor, served_score: torch.Tensor, K: int) -> Dict:
    """st_select_gap and st_score_err of one sampled batch (module
    docstring). steps: the program's kept set before each position i >= 2
    as (i, preds [B*K, Lbuf], scores [B*K]); served [B, T] with BOS first
    and its scores [B]. With control_memory (the TF32 reference's), also
    the control's: at each position TF32 ranks the same parents'
    candidates and keeps its own top K (and best, at the last), which the
    float32 reference reads."""
    mem, mask = memory
    B, T = served.shape
    V = model["dec_vocab_size"]
    dev = mem.device
    steps = sorted(steps, key=lambda s: s[0])
    prog = {"st_select_gap": 0.0, "st_score_err": 0.0}
    ctrl = {"st_select_gap": 0.0, "st_score_err": 0.0}
    if [s[0] for s in steps] != list(range(2, T)) or any(
            p.shape[0] != B * K or p.shape[1] < T - 1 for _, p, _ in steps):
        prog["st_select_gap"] = MISS  # positions or rows the program did not keep
        return {"program": prog, "control": ctrl if control_memory is not None else None}
    parents = torch.full((B, 1, 1), ref.BOS, dtype=torch.long, device=dev)
    par_ref = torch.zeros((B, 1), device=dev)
    par_ctl = torch.zeros((B, 1), device=dev)
    for j in range(1, T):
        lp = next_logps(model, params, parents, mem, mask)
        cand = (par_ref[..., None] + lp).reshape(B, -1)
        if j < T - 1:
            _, preds, scores = steps[j - 1]
            kept = preds.to(dev).long().view(B, K, -1)[:, :, :j + 1]
            got = scores.to(dev).float().view(B, K)
        else:
            kept, got = served.to(dev).long()[:, None, :], served_score.to(dev).float()[:, None]
        flat, ok = _match(kept, parents, V)
        flat = flat.clamp(0, cand.shape[1] - 1)
        picked = cand.gather(1, flat)
        prog["st_select_gap"] = max(prog["st_select_gap"], float(_rank_gap(cand, picked, ok)))
        if ok.any():
            prog["st_score_err"] = max(prog["st_score_err"],
                                       float((got - picked).abs()[ok].max()))
        if control_memory is not None:
            cmem, cmask = control_memory
            c_cand = (par_ctl[..., None] + next_logps(model, params, parents, cmem, cmask,
                                                      tf32=True)).reshape(B, -1)
            pick = c_cand.topk(kept.shape[1], dim=-1).indices
            ctrl["st_select_gap"] = max(ctrl["st_select_gap"], float(_rank_gap(
                cand, cand.gather(1, pick), torch.ones_like(pick, dtype=torch.bool))))
            c_kept = c_cand.gather(1, flat)
            if ok.any():
                ctrl["st_score_err"] = max(ctrl["st_score_err"],
                                           float((c_kept - picked).abs()[ok].max()))
            par_ctl = torch.where(ok, c_kept, got)
        parents, par_ref = kept, torch.where(ok, picked, got)
    return {"program": prog, "control": ctrl if control_memory is not None else None}


def _pool_outputs(outputs: List[Dict], sampled: List[Dict]) -> List[Dict]:
    """The sampled outputs, then the latest output of each pool batch that
    no sampled output covers."""
    seen = {o["pool"] for o in sampled}
    rest = {}
    for o in outputs:
        if o["pool"] not in seen:
            rest[o["pool"]] = o
    return list(sampled) + [rest[k] for k in sorted(rest)]


def decode_numbers(model: Dict, params: Dict, feats: Sequence, outputs: List[Dict],
                   sampled: List[Dict], K: int, device, control: bool = False):
    """The decode numbers (module docstring): asr_gap over the ASR
    hypotheses of every pool batch in outputs, the others over the sampled
    batches (each with "emb_host" and "steps_host"). With control, returns
    (the program's, the control's): the TF32 reference in the program's
    place on the same inputs, hypotheses and kept parents, read by the
    float32 reference (asr_gap: the gap of the symbol TF32 puts first)."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    cworst = dict.fromkeys(NUMBERS, 0.0)
    for n, out in enumerate(_pool_outputs(outputs, sampled)):
        f, lens = (t.to(device) for t in feats[out["pool"]])
        hyps = out["hyps"].to(device)
        dyn, las = las_logps(model, params, f, lens, hyps)
        worst["asr_gap"] = max(worst["asr_gap"], asr_gap(las, hyps))
        c_dyn = None
        if control:
            c_dyn, c_las = las_logps(model, params, f, lens, hyps, tf32=True)
            cworst["asr_gap"] = max(cworst["asr_gap"],
                                    asr_gap(las, hyps, c_las.argmax(-1)))
            del c_las
        del las
        if n < len(sampled):
            worst["dyn_emb_err"] = max(worst["dyn_emb_err"], rel_err(out["emb_host"].to(device),
                                                                      dyn))
            memory = st_memory(model, params, hyps, dyn)
            c_memory = None
            if control:
                cworst["dyn_emb_err"] = max(cworst["dyn_emb_err"], rel_err(c_dyn, dyn))
                c_memory = st_memory(model, params, hyps, c_dyn, tf32=True)
            got = beam_numbers(model, params, memory, c_memory, out["steps_host"],
                               out["tokens"], out["scores"], K)
            for key in ("st_select_gap", "st_score_err"):
                worst[key] = max(worst[key], got["program"][key])
                if control:
                    cworst[key] = max(cworst[key], got["control"][key])
            del memory, c_memory
        del dyn, c_dyn
    return (worst, cworst) if control else worst


# ---------------------------------------------------------------- training


def leaf_norm_err(got: List[torch.Tensor], want: List[torch.Tensor],
                  keep: Sequence[bool] = None) -> float:
    """max over leaves of |norm(got) - norm(want)| / max(norm(want), the
    median kept leaf's norm(want))."""
    n_got = [float(g.double().norm()) for g in got]
    n_want = [float(w.double().norm()) for w in want]
    keep = keep or [True] * len(got)
    kept = sorted(w for w, k in zip(n_want, keep) if k)
    med = kept[len(kept) // 2]
    return max(abs(a - b) / max(b, med) for a, b, k in zip(n_got, n_want, keep) if k)


def reference_steps(model: Dict, mode: str, params0: Dict, batches: List[Dict], lr: float,
                    max_norm: float, tf32: bool = False, drops: Sequence = None) -> Dict:
    """The reference's len(batches) steps from params0 (a fresh draw; its
    leaves are stepped in place), each with its step's draws (ref.Drops)
    where drops has them: {"losses": [{"nll_loss_en", "nll_loss_de"} a
    step], "grad1": the first clipped gradient, "change": the parameters'
    change, by leaf in weights.leaf_paths order}."""
    from perfbench.weights import leaf_paths

    ref.precise(tf32)
    try:
        leaves = [t for _, t in leaf_paths(params0)]
        start = [t.detach().clone() for t in leaves]
        for t in leaves:
            t.requires_grad_(True)
        adam = ref.Adam(leaves, lr)
        losses, grad1 = [], None
        for k, b in enumerate(batches):
            out = ref.train_losses(params0, model, mode, b, None if drops is None else drops[k])
            g = ref.clip(ref.grads_of(leaves, out["nll_loss_en"] + out["nll_loss_de"]), max_norm)
            losses.append({k: float(v.detach()) for k, v in out.items()})
            if grad1 is None:
                grad1 = [x.detach() for x in g]
            adam.step(g)
            del out, g
        change = [(p.detach() - s) for p, s in zip(leaves, start)]
    finally:
        ref.precise(False)
    return {"losses": losses, "grad1": grad1, "change": change}


def train_numbers(prog: Dict, want: Dict) -> Dict[str, float]:
    """The training numbers of `prog` (reference_steps' layout: the
    program's readings, or a control's) against the reference's `want`."""
    n_g = [float(x.double().norm()) for x in want["grad1"]]
    med = sorted(n_g)[len(n_g) // 2]
    moved = [n >= 1e-3 * med for n in n_g]
    loss_err = max(abs(pg[k] - rf[k]) / max(abs(rf[k]), 1e-12)
                   for pg, rf in zip(prog["losses"], want["losses"]) for k in rf if rf[k] != 0.0)
    dev = want["grad1"][0].device
    return {"loss_err": loss_err,
            "grad_err": leaf_norm_err([g.to(dev) for g in prog["grad1"]], want["grad1"]),
            "change_err": leaf_norm_err([c.to(dev) for c in prog["change"]], want["change"],
                                        moved)}
