"""K2: the free-running LAS greedy decoder (port of
stjep_tpu/ops/las_flash.py `las_greedy_flash`).

On CUDA tensors a host loop over the steps launches the per-step kernels of
`csrc/las_greedy.cu` and the shared GEMM; the emitted symbol stays on the
card, so the loop never synchronises. On CPU tensors `las_greedy_plain`
runs the same function in plain PyTorch, step for step as the JAX
package's XLA scan (`las_decoder_forward` with `want_logps=False`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.bridge import leaves
from stjep_tpu_torch.ops.attention import attend, linear
from stjep_tpu_torch.ops.lstm import lstm_cell_step


def _embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    from stjep_tpu_torch.models.las_decoder import embed

    return embed(table, ids)


def las_greedy_plain(params: Dict, cfg, wk: torch.Tensor,
                     att_values: torch.Tensor, lens_k: torch.Tensor,
                     sym0: torch.Tensor, n_steps: int,
                     ref_tokens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel. Returns (embs [B, n, Hs],
    preds [B, n] int64, picked [B, n]): the dynamic embeddings, the greedy
    symbols, and the log-softmax at ref_tokens[:, step] (token 0 without
    refs)."""
    B, Tk, Hd = wk.shape
    n = cfg.num_unilstm_dec
    dev = wk.device
    h = [torch.zeros((B, Hd), device=dev) for _ in range(n)]
    c = [torch.zeros((B, Hd), device=dev) for _ in range(n)]
    cell = torch.zeros((B, params["acous_ffn"]["w"].shape[1]), device=dev)
    sym = sym0.to(dev).long()
    mask = torch.arange(Tk, device=dev)[None, :] >= lens_k.to(dev)[:, None]
    if ref_tokens is None:
        ref_tokens = torch.zeros((B, n_steps), dtype=torch.long, device=dev)
    embs, preds, picked = [], [], []
    for step in range(n_steps):
        x = torch.cat([_embed(params["embedder"], sym), cell], dim=-1)
        h[0], c[0] = lstm_cell_step(params["dec_l0"], x, h[0], c[0])
        out = h[0]
        for i in range(1, n):
            h[i], c[i] = lstm_cell_step(params[f"dec_l{i}"], out, h[i], c[i])
            out = h[i] + out if i < n - 1 else h[i]  # middle residuals
        q = out[:, None, :]
        ctx, _ = attend(params["acous_att"], {"wk": wk}, q, att_values,
                        "bilinear", mask=mask)
        cell = linear(params["acous_ffn"], torch.cat([ctx, q], dim=-1))[:, 0]
        logp = torch.log_softmax(linear(params["acous_out"], cell), dim=-1)
        sym = torch.argmax(logp, dim=-1)
        embs.append(cell)
        preds.append(sym)
        picked.append(logp.gather(1, ref_tokens[:, step:step + 1].long())[:, 0])
    return (torch.stack(embs, dim=1), torch.stack(preds, dim=1),
            torch.stack(picked, dim=1))


def las_greedy_flash(params: Dict, cfg, wk: torch.Tensor,
                     att_values: torch.Tensor, lens_k: torch.Tensor,
                     sym0: torch.Tensor, n_steps: int,
                     ref_tokens: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the free-running decode: wk [B, Tk, Hd] precomputed bilinear key
    projections, att_values [B, Tk, 2Ha], lens_k [B] valid key positions,
    sym0 [B] first input symbol. Returns (embs [B, n, Hs], preds [B, n],
    picked [B, n])."""
    if not wk.is_cuda:
        return las_greedy_plain(params, cfg, wk, att_values, lens_k, sym0,
                                n_steps, ref_tokens)
    kernels.refuse_grad("las_greedy_flash",
                        "the teacher-forced LAS decoder (las_tf_scan)",
                        wk, att_values, *leaves(params))
    dev = wk.device
    f32, i32 = torch.float32, torch.int32
    B, Tk, Hd = wk.shape
    Ha2 = att_values.shape[-1]
    E = cfg.enc_embedding_size
    n = cfg.num_unilstm_dec
    table = params["embedder"].contiguous()
    V = table.shape[0]
    w_ffn = params["acous_ffn"]["w"].contiguous()
    Hs = w_ffn.shape[1]
    # each layer is one GEMM of [input ; h] against [W_ih ; W_hh]
    ws = [torch.cat([params[f"dec_l{i}"]["w_ih"], params[f"dec_l{i}"]["w_hh"]], 0)
          for i in range(n)]
    bs = [(params[f"dec_l{i}"]["b_ih"] + params[f"dec_l{i}"]["b_hh"]).contiguous()
          for i in range(n)]
    in_w = [E + Hs] + [Hd] * (n - 1)
    xin = [torch.zeros((B, w + Hd), device=dev, dtype=f32) for w in in_w]
    cs = torch.zeros((n, B, Hd), device=dev, dtype=f32)
    pre = torch.empty((B, 4 * Hd), device=dev, dtype=f32)
    ff_in = torch.empty((B, Ha2 + Hd), device=dev, dtype=f32)
    logits = torch.empty((B, V), device=dev, dtype=f32)
    embs = torch.empty((B, n_steps, Hs), device=dev, dtype=f32)
    preds = torch.empty((B, n_steps), device=dev, dtype=i32)
    picked = torch.empty((B, n_steps), device=dev, dtype=f32)
    sym = sym0.to(device=dev, dtype=i32).contiguous().clone()
    wk = wk.contiguous()
    att_values = att_values.contiguous()
    lens = lens_k.to(device=dev, dtype=i32).contiguous()
    refs = (ref_tokens.to(device=dev, dtype=i32).contiguous()
            if ref_tokens is not None else None)
    q = ff_in[:, Ha2:]
    for step in range(n_steps):
        cell = embs[:, step - 1] if step > 0 else None
        kernels.launch("las_embed_concat", table, sym, cell, n_steps * Hs,
                       xin[0], xin[0].stride(0), B, E, Hs)
        for i in range(n):
            kernels.gemm(xin[i], ws[i], bias=bs[i], out=pre)
            out_dst = xin[i + 1][:, :Hd] if i < n - 1 else q
            resid = xin[i][:, :Hd] if 0 < i < n - 1 else None
            kernels.launch("lstm_gates", pre, cs[i], None, xin[i][:, in_w[i]:],
                           xin[i].stride(0), out_dst, out_dst.stride(0),
                           resid, xin[i].stride(0), None, None, B, Hd)
        kernels.launch("bilinear_attend", q, ff_in.stride(0), wk, att_values,
                       lens, ff_in, ff_in.stride(0), None, None, B, Tk, Hd,
                       Ha2)
        kernels.gemm(ff_in, w_ffn, out=embs[:, step])
        kernels.gemm(embs[:, step], params["acous_out"]["w"],
                     bias=params["acous_out"]["b"], out=logits)
        kernels.launch("head_argmax", logits,
                       refs[:, step] if refs is not None else None, n_steps,
                       sym, preds[:, step], n_steps, picked[:, step], n_steps,
                       B, V)
    las_greedy_flash.launches += 1
    return embs, preds.long(), picked


las_greedy_flash.launches = 0
