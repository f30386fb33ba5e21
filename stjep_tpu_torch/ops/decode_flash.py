"""K3 / K4: transformer decode-step kernels (port of
stjep_tpu/ops/decode_flash.py `decode_chain_step_flash` and
`decode_beam_step_flash`).

K3 runs one decode position through every decoder layer and the decode
head; K4 is the whole beam while-body: embed + time signal, K3's layers and
head, and the k^2 -> k select with its back-copies. Design notes are in
`csrc/decode.cu`.

Layouts are the JAX kernels': self caches [nl, K, B, Lpad, D], never
reordered, read through the ancestry map anc [Lpad, B*K] (row r reads
position l from slot (anc[l, r], r // K)); memory K/V [nl, B, Lk_pad, D];
masks transposed (maskk [Lpad, B*K], mem_mask [Lk_pad, B]) and int32. Both
routes update the caches in place (the new K/V row at `pos`), and K4 also
sets anc[pos] to each row's own slot in place.

On CUDA tensors the wrappers launch the kernels; on CPU tensors they run
the `_plain` versions, which compute the same function in PyTorch, with the
same ancestry semantics, in the order of the JAX package's dense XLA path.
The int8 weight path (`quant=True`) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.config import EOS, PAD
from stjep_tpu_torch.ops.transformer import ATTN_MASK_FILL as NEG
from stjep_tpu_torch.ops.transformer import layer_norm

BLOCK = 16  # self-cache length is padded to a multiple of this
# what to differentiate through instead of K3/K4 (their CUDA routes have no backward)
TRAINABLE = "the full-sequence decoder (models/tf_decoder.py tf_decoder_forward)"
CROSS_BLOCK = 32  # memory length is padded to a multiple of this

CHAIN_KEYS = (
    ("decslf_attn", "layer_norm", "scale"), ("decslf_attn", "layer_norm", "bias"),
    ("decslf_attn", "w_qs", "w"), ("decslf_attn", "w_ks", "w"),
    ("decslf_attn", "w_vs", "w"), ("decslf_attn", "fc", "w"),
    ("encdec_attn", "layer_norm", "scale"), ("encdec_attn", "layer_norm", "bias"),
    ("encdec_attn", "w_qs", "w"), ("encdec_attn", "fc", "w"),
    ("pos_ffn", "layer_norm", "scale"), ("pos_ffn", "layer_norm", "bias"),
    ("pos_ffn", "w_1", "w"), ("pos_ffn", "w_1", "b"),
    ("pos_ffn", "w_2", "w"), ("pos_ffn", "w_2", "b"),
)


def pad_len(n: int, block: int = BLOCK) -> int:
    return ((n + block - 1) // block) * block


def stack_decoder_layers(dec_params: Dict) -> Tuple[torch.Tensor, ...]:
    """Each per-layer weight stacked into one contiguous [nl, ...] tensor,
    in CHAIN_KEYS order."""
    lps = list(dec_params["layers"])
    if "w_s" in lps[0]["decslf_attn"]["w_qs"]:
        raise NotImplementedError("int8 decoder weights are not ported yet")

    def leaf(lp, path):
        for p in path:
            lp = lp[p]
        return lp

    return tuple(torch.stack([leaf(lp, k) for lp in lps], 0).contiguous()
                 for k in CHAIN_KEYS)


def _ln(x, scale, bias, eps):
    return layer_norm({"scale": scale, "bias": bias}, x, eps)


def _attend_plain(q, k, v, valid, n_head):
    """q [BK, D]; k, v [BK, L, D]; valid [BK, L] bool -> [BK, D]."""
    BK, L, D = k.shape
    d = D // n_head
    qh = q.view(BK, n_head, d) / (d ** 0.5)
    s = torch.einsum("rnd,rlnd->rnl", qh, k.view(BK, L, n_head, d))
    s = s.masked_fill(~valid[:, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rnl,rlnd->rnd", p, v.view(BK, L, n_head, d)).reshape(BK, D)


def _layers_plain(stacked, x, cache_k, cache_v, mem_k, mem_v, pos, n_head,
                  anc, group, mem_mask, maskk):
    BK, D = x.shape
    row = torch.arange(BK, device=x.device)
    own, b = row % group, row // group
    lidx = torch.arange(pos + 1, device=x.device)
    ancp = anc[:pos + 1].T.long()  # [BK, pos+1]
    valid_self = maskk[:pos + 1].T != 0
    valid_mem = mem_mask.T[b] != 0  # [BK, Lk]
    for layer in range(cache_k.shape[0]):
        (slns, slnb, swq, swk, swv, swo, clns, clnb, cwq, cwo,
         flns, flnb, w1, b1, w2, b2) = (t[layer] for t in stacked)
        ck, cv = cache_k[layer], cache_v[layer]
        q = _ln(x, slns, slnb, 1e-6) @ swq
        ck[own, b, pos] = x @ swk
        cv[own, b, pos] = x @ swv
        ksel = ck[ancp, b[:, None], lidx[None, :]]  # [BK, pos+1, D]
        vsel = cv[ancp, b[:, None], lidx[None, :]]
        x = _attend_plain(q, ksel, vsel, valid_self, n_head) @ swo + x
        q = _ln(x, clns, clnb, 1e-6) @ cwq
        x = _attend_plain(q, mem_k[layer][b], mem_v[layer][b], valid_mem,
                          n_head) @ cwo + x
        h = torch.relu(_ln(x, flns, flnb, 1e-6) @ w1 + b1)
        x = h @ w2 + b2 + x
    return x


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k along the last dim by repeated arg-max: values descending, the
    lowest index first among ties (jax.lax.top_k's order; torch.topk
    documents none)."""
    x = x.clone()
    vals, ids = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)  # first occurrence
        vals.append(x.gather(-1, i))
        ids.append(i)
        x.scatter_(-1, i, -1e30)
    return torch.cat(vals, -1), torch.cat(ids, -1)


def _head_plain(x, norm_params, out_params, topk):
    logits = layer_norm(norm_params, x, 1e-5) @ out_params["w"]
    sc, ids = topk_lowest_index(torch.log_softmax(logits, dim=-1), topk)
    return sc, ids.to(torch.int32)


def decode_chain_step_plain(stacked, norm_params, out_params, x_new, cache_k,
                            cache_v, mem_k, mem_v, pos: int, n_head: int, anc,
                            group: int, mem_mask, self_mask_k, topk: int):
    """Plain PyTorch version of K3; same arguments and results."""
    x = _layers_plain(stacked, x_new, cache_k, cache_v, mem_k, mem_v, pos,
                      n_head, anc, group, mem_mask, self_mask_k)
    return _head_plain(x, norm_params, out_params, topk)


def _layers_cuda(stacked, x, cache_k, cache_v, mem_k, mem_v, pos, n_head,
                 anc, group, mem_mask, maskk):
    BK, D = x.shape
    Lpad, Lk = cache_k.shape[3], mem_k.shape[2]
    for layer in range(cache_k.shape[0]):
        (slns, slnb, swq, swk, swv, swo, clns, clnb, cwq, cwo,
         flns, flnb, w1, b1, w2, b2) = (t[layer] for t in stacked)
        q = kernels.gemm(kernels.layernorm(x, slns, slnb, 1e-6), swq)
        k_new, v_new = kernels.gemm(x, swk), kernels.gemm(x, swv)
        att = torch.empty_like(x)
        kernels.launch("self_attn_anc", q, k_new, v_new, cache_k[layer],
                       cache_v[layer], anc, maskk, att, pos, BK, group, Lpad,
                       D, n_head)
        x = kernels.gemm(att, swo, residual=x)
        q = kernels.gemm(kernels.layernorm(x, clns, clnb, 1e-6), cwq)
        kernels.launch("cross_attn", q, mem_k[layer], mem_v[layer], mem_mask,
                       att, BK, group, Lk, D, n_head)
        x = kernels.gemm(att, cwo, residual=x)
        h = kernels.gemm(kernels.layernorm(x, flns, flnb, 1e-6), w1, bias=b1,
                         relu=True)
        x = kernels.gemm(h, w2, bias=b2, residual=x)
    return x


def _head_cuda(x, norm_params, out_params, topk):
    logits = kernels.gemm(
        kernels.layernorm(x, norm_params["scale"], norm_params["bias"], 1e-5),
        out_params["w"])
    BK, V = logits.shape
    sc = torch.empty((BK, topk), device=x.device, dtype=torch.float32)
    ids = torch.empty((BK, topk), device=x.device, dtype=torch.int32)
    kernels.launch("head_topk", logits, sc, ids, BK, V, topk)
    return sc, ids


def _check_cuda_args(cache_k, anc, maskk, mem_mask):
    for t, nm in ((cache_k, "cache_k"), (anc, "anc"), (maskk, "self_mask_k"),
                  (mem_mask, "mem_mask")):
        kernels.check(t, torch.float32 if nm == "cache_k" else torch.int32, nm)


def decode_chain_step_flash(stacked, norm_params, out_params, x_new, cache_k,
                            cache_v, mem_k, mem_v, pos: int, n_head: int, anc,
                            group: int, mem_mask, self_mask_k, topk: int):
    """One decode position through all layers and the head.

    x_new [BK, D] (token embedding + time signal at `pos`); caches as in the
    module docstring, updated in place at `pos`; anc[pos] must hold each
    row's own slot. Returns (scores [BK, topk] log-probs, ids [BK, topk]
    int32), ties to the lowest id."""
    if not x_new.is_cuda:
        return decode_chain_step_plain(stacked, norm_params, out_params, x_new,
                                       cache_k, cache_v, mem_k, mem_v, pos,
                                       n_head, anc, group, mem_mask,
                                       self_mask_k, topk)
    kernels.refuse_grad("decode_chain_step_flash", TRAINABLE, x_new, mem_k,
                        mem_v, *stacked, *norm_params.values(),
                        *out_params.values())
    _check_cuda_args(cache_k, anc, self_mask_k, mem_mask)
    x = _layers_cuda(stacked, x_new.contiguous(), cache_k, cache_v, mem_k,
                     mem_v, pos, n_head, anc, group, mem_mask, self_mask_k)
    out = _head_cuda(x, norm_params, out_params, topk)
    decode_chain_step_flash.launches += 1
    return out


decode_chain_step_flash.launches = 0


def beam_candidates(sc, scores, eos, lenm, penalty_factor: float):
    """The k^2 candidate scores of a beam step (ref: Seq2seq.py:358-371):
    sc [BK, K] head log-probs; a finished row contributes column 0 at +0
    and -1e9 elsewhere; ranked by score / lenm^pf. Returns (st [B, K*K]
    with flat index j*K + c for source row b*K + j, lp = lenm^pf [BK])."""
    BK, K = sc.shape
    eosb = (eos != 0)[:, None]
    lp = lenm if penalty_factor == 1.0 else lenm ** penalty_factor
    col = torch.arange(K, device=sc.device)[None, :]
    sm = torch.where(eosb, torch.zeros_like(sc), sc)
    sm = torch.where(eosb & (col >= 1), torch.full_like(sc, NEG), sm)
    return ((scores[:, None] + sm) / lp[:, None]).reshape(BK // K, K * K), lp


def decode_beam_step_plain(stacked, norm_params, out_params, emb_table,
                           time_sig, i: int, last_tok, preds, anc, maskk,
                           mem_mask, scores, eos, lenm, cache_k, cache_v,
                           mem_k, mem_v, n_head: int, group: int,
                           penalty_factor: float):
    """Plain PyTorch version of K4; same arguments and results."""
    BK, L = preds.shape
    K = group
    B = BK // K
    pos = i - 1
    row = torch.arange(BK, device=preds.device)
    anc[pos] = (row % K).to(anc.dtype)
    tok = last_tok.long()
    x = emb_table[tok] * (tok != PAD)[:, None].to(emb_table.dtype) + time_sig[pos]
    x = _layers_plain(stacked, x, cache_k, cache_v, mem_k, mem_v, pos, n_head,
                      anc, K, mem_mask, maskk)
    sc, ids = _head_plain(x, norm_params, out_params, K)

    eosb = eos != 0
    st, lp = beam_candidates(sc, scores, eos, lenm, penalty_factor)
    sel, flat = topk_lowest_index(st, K)
    src = (torch.arange(B, device=preds.device)[:, None] * K + flat // K).view(-1)
    tok_sel = ids[src, (flat % K).view(-1)]
    preds_n = preds[src]  # advanced indexing copies
    preds_n[:, i] = tok_sel
    anc_n = anc[:, src].contiguous()
    maskk_n = maskk[:, src]
    maskk_n[i] = (tok_sel != PAD).to(maskk.dtype)
    eos_n = eosb | (tok_sel == EOS)
    lenm_n = lenm + torch.where(eos_n, 0.0, 1.0)
    flag = eos_n.all().to(torch.int32).reshape(1)
    return (preds_n, anc_n, maskk_n, tok_sel.to(torch.int32),
            sel.reshape(-1) * lp, eos_n.to(torch.int32), lenm_n, flag)


def decode_beam_step_flash(stacked, norm_params, out_params, emb_table,
                           time_sig, i: int, last_tok, preds, anc, maskk,
                           mem_mask, scores, eos, lenm, cache_k, cache_v,
                           mem_k, mem_v, n_head: int, group: int,
                           penalty_factor: float):
    """One beam position: embed last_tok [BK] + time_sig[i-1] -> layers ->
    head -> k^2 -> k select. preds [BK, Lpad] / anc / maskk [Lpad, BK] int32,
    scores / lenm [BK] f32, eos [BK] int32. Returns (preds, anc, maskk,
    last_tok, scores, eos, lenm, all_eos_flag [1]) as new tensors; the
    caches and anc[i-1] are updated in place."""
    if not preds.is_cuda:
        return decode_beam_step_plain(stacked, norm_params, out_params,
                                      emb_table, time_sig, i, last_tok, preds,
                                      anc, maskk, mem_mask, scores, eos, lenm,
                                      cache_k, cache_v, mem_k, mem_v, n_head,
                                      group, penalty_factor)
    kernels.refuse_grad("decode_beam_step_flash", TRAINABLE, emb_table,
                        time_sig, scores, mem_k, mem_v, *stacked,
                        *norm_params.values(), *out_params.values())
    _check_cuda_args(cache_k, anc, maskk, mem_mask)
    for t, dt, nm in ((last_tok, torch.int32, "last_tok"),
                      (preds, torch.int32, "preds"),
                      (scores, torch.float32, "scores"),
                      (eos, torch.int32, "eos"), (lenm, torch.float32, "lenm"),
                      (emb_table, torch.float32, "emb_table"),
                      (time_sig, torch.float32, "time_sig")):
        kernels.check(t, dt, nm)
    BK, L = preds.shape
    D = emb_table.shape[1]
    K = group
    dev = preds.device
    x = torch.empty((BK, D), device=dev, dtype=torch.float32)
    flag = torch.empty((1,), device=dev, dtype=torch.int32)
    kernels.launch("embed_time", emb_table, last_tok, time_sig, x, anc, flag,
                   i - 1, BK, K, D)
    x = _layers_cuda(stacked, x, cache_k, cache_v, mem_k, mem_v, i - 1, n_head,
                     anc, K, mem_mask, maskk)
    sc, ids = _head_cuda(x, norm_params, out_params, K)
    preds_n, anc_n, maskk_n = (torch.empty_like(preds), torch.empty_like(anc),
                               torch.empty_like(maskk))
    tok_n, eos_n = torch.empty_like(last_tok), torch.empty_like(eos)
    scores_n, lenm_n = torch.empty_like(scores), torch.empty_like(lenm)
    kernels.launch("beam_select", sc, ids, scores, eos, lenm, preds, anc,
                   maskk, preds_n, anc_n, maskk_n, tok_n, scores_n, eos_n,
                   lenm_n, flag, i, BK // K, K, L, float(penalty_factor))
    decode_beam_step_flash.launches += 1
    return preds_n, anc_n, maskk_n, tok_n, scores_n, eos_n, lenm_n, flag


decode_beam_step_flash.launches = 0
