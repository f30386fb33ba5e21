"""K8: the trainable bidirectional LSTM layer (port of
stjep_tpu/ops/lstm_pallas_bwd.py `bilstm_pallas_trainable`).

`bilstm_pallas_trainable` is a `torch.autograd.Function`. Its forward runs
the input projections and the recurrent sweep of both directions, saving
per step the carries before the step (h_{t-1}, c_{t-1}) and the gate
activations, time-major `[dir, T, B, .]` as the JAX kernel lays them out
(gates are zero at steps past a row's length). Its backward runs the
reverse-time sweep, which emits the dPre stream `[dir, T, B, 4H]` and keeps
dh/dc carried (at a padded step the carries keep their values and the
output's cotangent there is dropped); dW_hh, dW_ih, db (the same for b_ih
and b_hh) and dX are finished by stream matmuls outside the kernel, as the
JAX code finishes them (`lstm_pallas_bwd.py:309-348`).

On CUDA tensors the forward launches K1's sweep in its saving variant
(`csrc/bilstm.cu`, after one GEMM per direction for the input projections)
and the backward `csrc/bilstm_bwd.cu`; on CPU tensors the same Function
runs `bilstm_fwd_save_plain` and `bilstm_bwd_plain`, explicit time loops
that produce the same streams. The TPU kernels keep the streams in bf16;
the port keeps f32 (the JAX package's parity mode).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.ops.lstm import lstm_gates

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def bilstm_fwd_save_plain(w_ih: Tuple, w_hh: Tuple, bias: Tuple,
                          x: torch.Tensor, lengths: torch.Tensor):
    """Plain PyTorch version of the saving forward. w_ih / w_hh / bias hold
    one tensor per direction (bias = b_ih + b_hh). Returns (out [B, T, 2H],
    hs [2, T, B, H], cs [2, T, B, H], gates [2, T, B, 4H])."""
    B, T, _ = x.shape
    H = w_hh[0].shape[0]
    out = x.new_zeros((B, T, 2 * H))
    hs = x.new_zeros((2, T, B, H))
    cs = torch.zeros_like(hs)
    gates = x.new_zeros((2, T, B, 4 * H))
    valid = (torch.arange(T, device=x.device)[:, None] < lengths[None, :])[..., None]
    for d in range(2):
        xp = (x @ w_ih[d] + bias[d]).transpose(0, 1)  # [T, B, 4H]
        h = x.new_zeros((B, H))
        c = torch.zeros_like(h)
        for t in (range(T) if d == 0 else range(T - 1, -1, -1)):
            hs[d, t], cs[d, t] = h, c
            h_new, c_new, gcat = lstm_gates(xp[t] + h @ w_hh[d], c, H,
                                            with_gates=True)
            v = valid[t]
            gates[d, t] = torch.where(v, gcat, torch.zeros_like(gcat))
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            out[:, t, d * H:(d + 1) * H] = torch.where(v, h_new, torch.zeros_like(h_new))
    return out, hs, cs, gates


def bilstm_bwd_plain(g_out: torch.Tensor, cs: torch.Tensor, gates: torch.Tensor,
                     w_hh: Tuple, lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the reverse sweep: g_out [B, T, 2H] ->
    dxp [2, T, B, 4H], the pre-activation cotangents (zero past a row's
    length)."""
    _, T, B, H = cs.shape
    dxp = torch.zeros_like(gates)
    valid = (torch.arange(T, device=cs.device)[:, None] < lengths[None, :])[..., None]
    for d in range(2):
        dh = g_out.new_zeros((B, H))
        dc = torch.zeros_like(dh)
        for t in (range(T - 1, -1, -1) if d == 0 else range(T)):
            i, f, g, o = gates[d, t].split(H, dim=-1)
            c_prev = cs[d, t]
            tanh_c = torch.tanh(f * c_prev + i * g)
            dh_t = g_out[:, t, d * H:(d + 1) * H] + dh
            d_o = dh_t * tanh_c
            dc_t = dc + dh_t * o * (1.0 - tanh_c * tanh_c)
            dpre = torch.cat([dc_t * g * i * (1.0 - i), dc_t * c_prev * f * (1.0 - f),
                              dc_t * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1)
            v = valid[t]
            dpre = torch.where(v, dpre, torch.zeros_like(dpre))
            dxp[d, t] = dpre
            dh = torch.where(v, dpre @ w_hh[d].T, dh)
            dc = torch.where(v, dc_t * f, dc)
    return dxp


# ---------------------------------------------------------------------------
# kernel routes
# ---------------------------------------------------------------------------


def bilstm_fwd_save(w_ih: Tuple, w_hh: Tuple, bias: Tuple, x: torch.Tensor,
                    lengths: torch.Tensor):
    """K8 forward on the card; same arguments and results as
    bilstm_fwd_save_plain."""
    B, T, Din = x.shape
    H = w_hh[0].shape[0]
    x2 = x.reshape(B * T, Din).contiguous()
    xp = [kernels.gemm(x2, w_ih[d].contiguous(), bias=bias[d].contiguous())
          for d in range(2)]
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, T, 2 * H), device=x.device, dtype=torch.float32)
    hs = torch.empty((2, T, B, H), device=x.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    gates = torch.empty((2, T, B, 4 * H), device=x.device, dtype=torch.float32)
    kernels.launch("bilstm_fwd_save", xp[0], xp[1], w_hh[0].contiguous(),
                   w_hh[1].contiguous(), lens, out, hs, cs, gates, B, T, H)
    bilstm_fwd_save.launches += 1
    return out, hs, cs, gates


bilstm_fwd_save.launches = 0


def bilstm_bwd(g_out: torch.Tensor, cs: torch.Tensor, gates: torch.Tensor,
               w_hh: Tuple, lengths: torch.Tensor) -> torch.Tensor:
    """K8 backward on the card; same arguments and result as
    bilstm_bwd_plain."""
    _, T, B, H = cs.shape
    kernels.check(cs, name="cs")
    kernels.check(gates, name="gates")
    lens = lengths.to(device=cs.device, dtype=torch.int32).contiguous()
    dxp = torch.empty_like(gates)
    kernels.launch("bilstm_bwd_recurrent", g_out.contiguous(), cs, gates,
                   w_hh[0].t().contiguous(), w_hh[1].t().contiguous(), lens,
                   dxp, B, T, H)
    bilstm_bwd.launches += 1
    return dxp


bilstm_bwd.launches = 0


# ---------------------------------------------------------------------------
# the autograd.Function
# ---------------------------------------------------------------------------


class _BiLSTMTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lengths, wif, whf, bif, bhf, wib, whb, bib, bhb):
        w_ih, w_hh = (wif, wib), (whf, whb)
        bias = (bif + bhf, bib + bhb)
        fwd = bilstm_fwd_save if x.is_cuda else bilstm_fwd_save_plain
        out, hs, cs, gates = fwd(w_ih, w_hh, bias, x, lengths)
        ctx.save_for_backward(x, lengths, wif, whf, wib, whb)
        ctx.streams = (hs, cs, gates)
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, lengths, wif, whf, wib, whb = ctx.saved_tensors
        hs, cs, gates = ctx.streams
        bwd = bilstm_bwd if g_out.is_cuda else bilstm_bwd_plain
        dxp = bwd(g_out, cs, gates, (whf, whb), lengths)  # [2, T, B, 4H]
        H = whf.shape[0]
        grads = []
        for d in range(2):
            db = dxp[d].sum(dim=(0, 1))
            grads += [torch.einsum("btk,tbf->kf", x, dxp[d]),  # dW_ih
                      hs[d].reshape(-1, H).T @ dxp[d].reshape(-1, 4 * H),  # dW_hh
                      db, db]
        dx = (torch.einsum("tbf,kf->btk", dxp[0], wif)
              + torch.einsum("tbf,kf->btk", dxp[1], wib))
        return (dx, None, *grads)


def bilstm_pallas_trainable(params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, Din] -> [B, T, 2H] with packed-length semantics, differentiable
    in x and every weight."""
    B, T, _ = x.shape
    if lengths is None:
        lengths = torch.full((B,), T, device=x.device)
    lengths = lengths.to(device=x.device, dtype=torch.int64)
    pf, pb = params_fwd, params_bwd
    return _BiLSTMTrainable.apply(x, lengths, pf["w_ih"], pf["w_hh"], pf["b_ih"],
                                  pf["b_hh"], pb["w_ih"], pb["w_hh"], pb["b_ih"],
                                  pb["b_hh"])
