"""K9: the teacher-forced LAS decoder scan, forward and backward (port of
stjep_tpu/ops/las_tf_flash.py `las_tf_scan`).

`las_tf_scan` is a `torch.autograd.Function` over S teacher-forced steps.
Each step runs the 3-layer residual uni-LSTM on [x ; h] @ [W_ih ; W_hh]
(layer 0's embedding side comes in hoisted as `pre0_steps`, with both
biases), bilinear attention with the -1e12 fill past `lens_k`, and the FFN
[ctx_m ; q] @ W_ffn (no bias) that gives the dynamic embedding, which is
the next step's layer-0 input. Dropout masks come in hoisted (or None).

The forward keeps its saved streams in the form the GEMMs read them, so
nothing is copied to save it:
    x0 [S+1, B, Hs+Hd] = [cell_{t-1} ; h0_{t-1}]  (layer-0 GEMM input)
    x1, x2 [S+1, B, 2Hd] = [in_l ; h_l,{t-1}]     (layers 1, 2)
    ff [S, B, Ha2+Hd]    = [ctx_m ; q]             (FFN input)
    c [3, S+1, B, Hd]    = cell states before each step
    g [3, S, B, 4Hd]     = gate activations;  attn [S, B, Tk]
(row S of x0/x1/x2/c is the state after the last step). The backward runs
the reverse steps and returns the dpre [3, S, B, 4Hd], d_scores [S, B, Tk],
dctx [S, B, Ha2] and dcell [S, B, Hs] streams; every weight gradient,
d_wk -> d_att_w and d_acous are finished outside by stream matmuls, as the
JAX code does (`las_tf_flash.py:432-487`).

Layer 0's embedding-side rows of W_ih and its biases get zero here: their
gradient flows through `pre0_steps`, which the caller computes with plain
autograd from the same `dec_l0.w_ih`, so autograd sums the two parts.

On CUDA tensors the Function launches the kernels of `csrc/las_tf.cu` (with
K2's per-step kernels and the shared GEMM) from host loops that never
synchronise; on CPU tensors it runs `las_tf_fwd_plain` and
`las_tf_bwd_plain`, explicit time loops that produce the same streams. The
TPU kernels keep streams and weights in bf16; the port keeps f32 (the JAX
package's parity mode).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.ops.attention import MASK_FILL
from stjep_tpu_torch.ops.lstm import lstm_gates


class Weights(NamedTuple):
    """The scan's weights in the form the steps read them."""

    w0: torch.Tensor  # [Hs+Hd, 4Hd] = [dec_l0.w_ih[E:] ; dec_l0.w_hh]
    w1: torch.Tensor  # [2Hd, 4Hd]
    b1: torch.Tensor  # [4Hd] = b_ih + b_hh
    w2: torch.Tensor
    b2: torch.Tensor
    ffn: torch.Tensor  # [Ha2+Hd, Hs]


class Streams(NamedTuple):
    """What the forward saves for the backward (module docstring)."""

    x0: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor
    ff: torch.Tensor
    c: torch.Tensor
    g: torch.Tensor
    attn: torch.Tensor


class Masks(NamedTuple):
    """Per-step inverted-dropout masks: lstm [S, 3, B, Hd], ctx [S, B, Ha2]."""

    lstm: torch.Tensor
    ctx: torch.Tensor


def _new_streams(pre0: torch.Tensor, w: Weights, Tk: int) -> Streams:
    S, B, _ = pre0.shape
    Hd = w.w1.shape[1] // 4
    Hs, Ha2 = w.ffn.shape[1], w.ffn.shape[0] - Hd
    z = lambda *shape: torch.zeros(shape, device=pre0.device, dtype=pre0.dtype)
    return Streams(x0=z(S + 1, B, Hs + Hd), x1=z(S + 1, B, 2 * Hd),
                   x2=z(S + 1, B, 2 * Hd), ff=z(S, B, Ha2 + Hd),
                   c=z(3, S + 1, B, Hd), g=z(3, S, B, 4 * Hd), attn=z(S, B, Tk))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def las_tf_fwd_plain(w: Weights, pre0: torch.Tensor, wk: torch.Tensor,
                     values: torch.Tensor, lens_k: torch.Tensor,
                     masks: Optional[Masks]) -> Streams:
    """Plain PyTorch version of the forward: pre0 [S, B, 4Hd], wk [B, Tk, Hd]
    (= values @ att_w), values [B, Tk, Ha2], lens_k [B]. Returns the
    streams; the dynamic embeddings are st.x0[1:, :, :Hs]."""
    S = pre0.shape[0]
    Tk = values.shape[1]
    Hd = w.w1.shape[1] // 4
    Hs, Ha2 = w.ffn.shape[1], w.ffn.shape[0] - Hd
    st = _new_streams(pre0, w, Tk)
    blocked = torch.arange(Tk, device=values.device)[None, :] >= lens_k[:, None]
    for t in range(S):
        m = [None] * 3 if masks is None else masks.lstm[t]
        ins = (st.x0, st.x1, st.x2)
        outs = (st.x1[t, :, :Hd], st.x2[t, :, :Hd], st.ff[t, :, Ha2:])
        for layer in range(3):
            x = ins[layer][t]
            pre = x @ (w.w0, w.w1, w.w2)[layer]
            pre = pre0[t] + pre if layer == 0 else pre + (w.b1, w.b2)[layer - 1]
            h, c, g = lstm_gates(pre, st.c[layer, t], Hd, with_gates=True)
            st.c[layer, t + 1], st.g[layer, t] = c, g
            ins[layer][t + 1, :, x.shape[1] - Hd:] = h
            y = h + x[:, :Hd] if layer == 1 else h
            outs[layer][:] = y if masks is None else y * m[layer]
        q = st.ff[t, :, Ha2:]
        scores = torch.einsum("bh,bth->bt", q, wk)
        attn = torch.softmax(torch.where(blocked, torch.full_like(scores, MASK_FILL),
                                         scores), dim=-1)
        st.attn[t] = attn
        ctx = torch.einsum("bt,btd->bd", attn, values)
        st.ff[t, :, :Ha2] = ctx if masks is None else ctx * masks.ctx[t]
        st.x0[t + 1, :, :Hs] = st.ff[t] @ w.ffn
    return st


def _cell_bwd(go, g, c_prev, dh, dc, H):
    """One LSTM cell backward (stjep_tpu las_tf_flash.py `lstm_bwd`):
    returns (dpre [B, 4H], dc for step t-1)."""
    i, f, gg, o = g.split(H, dim=-1)
    tanh_c = torch.tanh(f * c_prev + i * gg)
    dh_t = go + dh
    dc_t = dc + dh_t * o * (1.0 - tanh_c * tanh_c)
    dpre = torch.cat([dc_t * gg * i * (1.0 - i), dc_t * c_prev * f * (1.0 - f),
                      dc_t * i * (1.0 - gg * gg), dh_t * tanh_c * o * (1.0 - o)],
                     dim=-1)
    return dpre, dc_t * f


def las_tf_bwd_plain(w: Weights, st: Streams, g_cell: torch.Tensor,
                     wk: torch.Tensor, values: torch.Tensor,
                     masks: Optional[Masks]):
    """Plain PyTorch version of the backward from the cotangent of the
    dynamic embeddings g_cell [S, B, Hs]. Returns (dpre [3, S, B, 4Hd],
    dsc [S, B, Tk], dctx [S, B, Ha2], dcell [S, B, Hs])."""
    S, B, Hs = g_cell.shape
    Hd = w.w1.shape[1] // 4
    Ha2 = values.shape[-1]
    dpre = torch.zeros_like(st.g)
    dsc = torch.zeros_like(st.attn)
    dctx_s = g_cell.new_zeros((S, B, Ha2))
    dcell_s = torch.zeros_like(g_cell)
    dh = [g_cell.new_zeros((B, Hd)) for _ in range(3)]
    dc = [g_cell.new_zeros((B, Hd)) for _ in range(3)]
    dcell = torch.zeros_like(g_cell[0])
    for t in range(S - 1, -1, -1):
        m = [1.0] * 3 if masks is None else masks.lstm[t]
        dcell_t = g_cell[t] + dcell
        dcell_s[t] = dcell_t
        dff = dcell_t @ w.ffn.T
        dctx = dff[:, :Ha2] if masks is None else dff[:, :Ha2] * masks.ctx[t]
        dctx_s[t] = dctx
        attn = st.attn[t]
        datt = torch.einsum("bd,btd->bt", dctx, values)
        dsc[t] = attn * (datt - (attn * datt).sum(dim=-1, keepdim=True))
        dq = dff[:, Ha2:] + torch.einsum("bt,bth->bh", dsc[t], wk)
        # layer 2, then 1 (residual: y1 = h1 + x1), then 0
        dpre[2, t], dc[2] = _cell_bwd(dq * m[2], st.g[2, t], st.c[2, t], dh[2], dc[2], Hd)
        dxh = dpre[2, t] @ w.w2.T
        dx2, dh[2] = dxh[:, :Hd], dxh[:, Hd:]
        dy1 = dx2 * m[1]
        dpre[1, t], dc[1] = _cell_bwd(dy1, st.g[1, t], st.c[1, t], dh[1], dc[1], Hd)
        dxh = dpre[1, t] @ w.w1.T
        dh[1] = dxh[:, Hd:]
        go0 = (dy1 + dxh[:, :Hd]) * m[0]
        dpre[0, t], dc[0] = _cell_bwd(go0, st.g[0, t], st.c[0, t], dh[0], dc[0], Hd)
        dxh = dpre[0, t] @ w.w0.T
        dcell, dh[0] = dxh[:, :Hs], dxh[:, Hs:]
    return dpre, dsc, dctx_s, dcell_s


# ---------------------------------------------------------------------------
# kernel routes
# ---------------------------------------------------------------------------


def las_tf_fwd(w: Weights, pre0: torch.Tensor, wk: torch.Tensor,
               values: torch.Tensor, lens_k: torch.Tensor,
               masks: Optional[Masks]) -> Streams:
    """K9 forward on the card; same arguments and result as
    las_tf_fwd_plain."""
    S, B, _ = pre0.shape
    Tk = values.shape[1]
    Hd = w.w1.shape[1] // 4
    Hs, Ha2 = w.ffn.shape[1], w.ffn.shape[0] - Hd
    for t_, nm in ((pre0, "pre0"), (wk, "wk"), (values, "values"), *zip(w, Weights._fields)):
        kernels.check(t_, name=nm)
    lens = lens_k.to(dtype=torch.int32).contiguous()
    st = _new_streams(pre0, w, Tk)
    pre = torch.empty((B, 4 * Hd), device=pre0.device, dtype=torch.float32)
    ld0, ld1, ldf = st.x0.stride(1), st.x1.stride(1), st.ff.stride(1)
    for t in range(S):
        m = (None,) * 3 if masks is None else masks.lstm[t]
        kernels.gemm(st.x0[t], w.w0, residual=pre0[t], out=pre)
        kernels.launch("lstm_gates", pre, st.c[0, t], st.c[0, t + 1],
                       st.x0[t + 1, :, Hs:], ld0, st.x1[t, :, :Hd], ld1, None, 0,
                       m[0], st.g[0, t], B, Hd)
        kernels.gemm(st.x1[t], w.w1, bias=w.b1, out=pre)
        kernels.launch("lstm_gates", pre, st.c[1, t], st.c[1, t + 1],
                       st.x1[t + 1, :, Hd:], ld1, st.x2[t, :, :Hd], ld1,
                       st.x1[t, :, :Hd], ld1, m[1], st.g[1, t], B, Hd)
        kernels.gemm(st.x2[t], w.w2, bias=w.b2, out=pre)
        kernels.launch("lstm_gates", pre, st.c[2, t], st.c[2, t + 1],
                       st.x2[t + 1, :, Hd:], ld1, st.ff[t, :, Ha2:], ldf, None, 0,
                       m[2], st.g[2, t], B, Hd)
        kernels.launch("bilinear_attend", st.ff[t, :, Ha2:], ldf, wk, values,
                       lens, st.ff[t], ldf, st.attn[t],
                       None if masks is None else masks.ctx[t], B, Tk, Hd, Ha2)
        kernels.gemm(st.ff[t], w.ffn, out=st.x0[t + 1, :, :Hs])
    las_tf_fwd.launches += 1
    return st


las_tf_fwd.launches = 0


def las_tf_bwd(w: Weights, st: Streams, g_cell: torch.Tensor, wk: torch.Tensor,
               values: torch.Tensor, masks: Optional[Masks]):
    """K9 backward on the card; same arguments and results as
    las_tf_bwd_plain."""
    S, B, Hs = g_cell.shape
    Tk = values.shape[1]
    Hd = w.w1.shape[1] // 4
    Ha2 = values.shape[-1]
    dev, f32 = g_cell.device, torch.float32
    g_cell = g_cell.contiguous()
    wT = [t_.t().contiguous() for t_ in (w.w0, w.w1, w.w2, w.ffn)]
    # dx0[t] = d[cell_{t-1} ; h0_{t-1}]: layer 0's GEMM adds gc[t] = [g_cell[t-1] ; 0],
    # so dx0[t][:, :Hs] is the full cotangent of cell_{t-1}
    gc = torch.zeros((S + 1, B, Hs + Hd), device=dev, dtype=f32)
    gc[1:, :, :Hs] = g_cell
    dx0 = torch.zeros_like(gc)
    dx0[S] = gc[S]
    dx1 = torch.zeros((S + 1, B, 2 * Hd), device=dev, dtype=f32)
    dx2 = torch.zeros_like(dx1)
    dc = torch.zeros((3, B, Hd), device=dev, dtype=f32)
    dpre = torch.empty_like(st.g)
    dsc = torch.empty_like(st.attn)
    dctx = torch.empty((S, B, Ha2), device=dev, dtype=f32)
    dff = torch.empty((B, Ha2 + Hd), device=dev, dtype=f32)
    dq = torch.empty((B, Hd), device=dev, dtype=f32)
    dy1 = torch.empty_like(dq)
    ld0, ld1 = dx0.stride(1), dx1.stride(1)
    for t in range(S - 1, -1, -1):
        m = (None,) * 3 if masks is None else masks.lstm[t]
        kernels.gemm(dx0[t + 1, :, :Hs], wT[3], out=dff)
        kernels.launch("attend_bwd", dff, dff.stride(0),
                       None if masks is None else masks.ctx[t], st.attn[t],
                       values, wk, dsc[t], dctx[t], dq, B, Tk, Ha2, Hd)
        kernels.launch("lstm_cell_bwd", dq, Hd, None, 0, m[2], None, st.g[2, t],
                       st.c[2, t], dx2[t + 1, :, Hd:], ld1, dc[2], dpre[2, t], B, Hd)
        kernels.gemm(dpre[2, t], wT[2], out=dx2[t])
        kernels.launch("lstm_cell_bwd", dx2[t, :, :Hd], ld1, None, 0, m[1], dy1,
                       st.g[1, t], st.c[1, t], dx1[t + 1, :, Hd:], ld1, dc[1],
                       dpre[1, t], B, Hd)
        kernels.gemm(dpre[1, t], wT[1], out=dx1[t])
        kernels.launch("lstm_cell_bwd", dy1, Hd, dx1[t, :, :Hd], ld1, m[0], None,
                       st.g[0, t], st.c[0, t], dx0[t + 1, :, Hs:], ld0, dc[0],
                       dpre[0, t], B, Hd)
        kernels.gemm(dpre[0, t], wT[0], residual=gc[t], out=dx0[t])
    las_tf_bwd.launches += 1
    return dpre, dsc, dctx, dx0[1:, :, :Hs]


las_tf_bwd.launches = 0


# ---------------------------------------------------------------------------
# the autograd.Function
# ---------------------------------------------------------------------------


def scan_weights(w0_ih, w0_hh, w1_ih, w1_hh, b1_ih, b1_hh, w2_ih, w2_hh, b2_ih,
                 b2_hh, ffn_w) -> Weights:
    """The three LSTM layers' and the FFN's params as the steps read them."""
    E = w0_ih.shape[0] - ffn_w.shape[1]  # layer-0 input = [emb (E) ; cell (Hs)]
    return Weights(w0=torch.cat([w0_ih[E:], w0_hh], 0).contiguous(),
                   w1=torch.cat([w1_ih, w1_hh], 0).contiguous(),
                   b1=(b1_ih + b1_hh).contiguous(),
                   w2=torch.cat([w2_ih, w2_hh], 0).contiguous(),
                   b2=(b2_ih + b2_hh).contiguous(), ffn=ffn_w.contiguous())


class _LasTFScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre0, acous, lens_k, m_lstm, m_ctx, att_w, w0_ih, w0_hh,
                w1_ih, w1_hh, b1_ih, b1_hh, w2_ih, w2_hh, b2_ih, b2_hh, ffn_w):
        w = scan_weights(w0_ih, w0_hh, w1_ih, w1_hh, b1_ih, b1_hh, w2_ih, w2_hh,
                     b2_ih, b2_hh, ffn_w)
        masks = None if m_lstm is None else Masks(m_lstm.contiguous(),
                                                  m_ctx.contiguous())
        acous = acous.contiguous()
        wk = (acous @ att_w).contiguous()
        fwd = las_tf_fwd if pre0.is_cuda else las_tf_fwd_plain
        st = fwd(w, pre0.contiguous(), wk, acous, lens_k, masks)
        ctx.save_for_backward(acous, att_w, w0_ih, ffn_w)
        ctx.scan = (w, st, wk, masks)
        return st.x0[1:, :, :ffn_w.shape[1]].contiguous()

    @staticmethod
    def backward(ctx, g_cell):
        acous, att_w, w0_ih, ffn_w = ctx.saved_tensors
        w, st, wk, masks = ctx.scan
        bwd = las_tf_bwd if g_cell.is_cuda else las_tf_bwd_plain
        dpre, dsc, dctx, dcell = bwd(w, st, g_cell, wk, acous, masks)
        S, B, _ = g_cell.shape
        Hs, Hd = ffn_w.shape[1], w.w1.shape[1] // 4
        Ha2 = acous.shape[-1]
        flat = lambda a: a.reshape(-1, a.shape[-1])
        dw = [flat(x[:S]).T @ flat(dpre[i]) for i, x in enumerate((st.x0, st.x1, st.x2))]
        db = [flat(dpre[i]).sum(0) for i in (1, 2)]
        E = w0_ih.shape[0] - Hs
        d_w0_ih = torch.cat([dw[0].new_zeros((E, 4 * Hd)), dw[0][:Hs]], 0)
        d_ffn = flat(st.ff).T @ flat(dcell)
        d_wk = torch.einsum("sbt,sbh->bth", dsc, st.ff[:, :, Ha2:])
        d_att_w = flat(acous).T @ flat(d_wk)
        d_acous = torch.einsum("sbt,sbd->btd", st.attn, dctx) + d_wk @ att_w.T
        return (dpre[0], d_acous, None, None, None, d_att_w, d_w0_ih, dw[0][Hs:],
                dw[1][:Hd], dw[1][Hd:], db[0], db[0], dw[2][:Hd], dw[2][Hd:],
                db[1], db[1], d_ffn)


def las_tf_scan(stack: Dict, att_w: torch.Tensor, ffn_w: torch.Tensor,
                pre0_steps: torch.Tensor, acous_outputs: torch.Tensor,
                lens_k: torch.Tensor,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Teacher-forced decoder scan. stack: {dec_l0, dec_l1, dec_l2} LSTM
    params; att_w: bilinear weight [Ha2, Hd]; ffn_w [Ha2+Hd, Hs];
    pre0_steps [S, B, 4Hd]: hoisted layer-0 embedding-side pre-activation
    with both biases; masks: (lstm [S, 3, B, Hd], ctx [S, B, 1, Ha2])
    inverted-dropout masks, or None. Returns the dynamic embeddings
    [S, B, Hs], time-major."""
    p0, p1, p2 = (stack[f"dec_l{i}"] for i in range(3))
    m_lstm, m_ctx = (None, None) if masks is None else (masks[0], masks[1][:, :, 0])
    lens = lens_k.to(device=pre0_steps.device, dtype=torch.int64)
    return _LasTFScan.apply(pre0_steps, acous_outputs, lens, m_lstm, m_ctx, att_w,
                            p0["w_ih"], p0["w_hh"], p1["w_ih"], p1["w_hh"],
                            p1["b_ih"], p1["b_hh"], p2["w_ih"], p2["w_hh"],
                            p2["b_ih"], p2["b_hh"], ffn_w)
