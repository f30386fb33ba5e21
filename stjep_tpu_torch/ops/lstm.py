"""LSTM recurrences with packed-sequence semantics (port of
stjep_tpu/ops/lstm.py).

Outside a sequence's valid length the carries pass through unchanged and the
output is zero, so a reversed sweep starts at the last valid frame exactly
as torch's pack_padded_sequence does. Gate order is torch's (i, f, g, o);
weights are `[in, 4H]` / `[H, 4H]`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def lstm_init(generator: torch.Generator, input_size: int, hidden_size: int,
              device=None, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Uniform(-1/sqrt(H), 1/sqrt(H)), torch.nn.LSTM's default, drawn in
    f32 and stored in `dtype`."""
    k = 1.0 / math.sqrt(hidden_size)

    def u(shape):
        return (torch.rand(shape, generator=generator) * (2 * k) - k).to(device, dtype)

    return {
        "w_ih": u((input_size, 4 * hidden_size)),
        "w_hh": u((hidden_size, 4 * hidden_size)),
        "b_ih": u((4 * hidden_size,)),
        "b_hh": u((4 * hidden_size,)),
    }


def bilstm_init(generator: torch.Generator, input_size: int, hidden_size: int,
                device=None, dtype=torch.float32) -> Dict:
    return {"fwd": lstm_init(generator, input_size, hidden_size, device, dtype),
            "bwd": lstm_init(generator, input_size, hidden_size, device, dtype)}


def lstm_gates(pre: torch.Tensor, c: torch.Tensor, hidden_size: int,
               with_gates: bool = False):
    """(i, f, g, o) nonlinearities on pre [B, 4H]; returns (h', c'), or
    with_gates=True (h', c', concat(i, f, g, o)) for the kernels' plain
    versions that save gate activations."""
    H = hidden_size
    i = torch.sigmoid(pre[:, 0 * H:1 * H])
    f = torch.sigmoid(pre[:, 1 * H:2 * H])
    g = torch.tanh(pre[:, 2 * H:3 * H])
    o = torch.sigmoid(pre[:, 3 * H:4 * H])
    c_new = f * c + i * g
    if with_gates:
        return o * torch.tanh(c_new), c_new, torch.cat([i, f, g, o], dim=-1)
    return o * torch.tanh(c_new), c_new


def lstm_cell_step(params: Dict, x_t: torch.Tensor, h: torch.Tensor,
                   c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: x_t [B, D], h/c [B, H] -> (h', c')."""
    pre = x_t @ params["w_ih"] + h @ params["w_hh"] + params["b_ih"] + params["b_hh"]
    return lstm_gates(pre, c, h.shape[-1])


def lstm_scan(params: Dict, x: torch.Tensor,
              lengths: Optional[torch.Tensor] = None,
              reverse: bool = False) -> torch.Tensor:
    """x [B, T, D] -> outputs [B, T, H], zero at t >= lengths."""
    B, T, _ = x.shape
    H = params["w_hh"].shape[0]
    x_proj = x @ params["w_ih"] + (params["b_ih"] + params["b_hh"])  # [B,T,4H]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int64, device=x.device)
    h = torch.zeros((B, H), dtype=x_proj.dtype, device=x.device)
    c = torch.zeros_like(h)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new = lstm_gates(x_proj[:, t] + h @ params["w_hh"], c, H)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs[t] = torch.where(valid, h_new, torch.zeros_like(h_new))
    return torch.stack(outs, dim=1)


def bilstm(params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """concat(forward, backward) -> [B, T, 2H]."""
    return torch.cat([lstm_scan(params_fwd, x, lengths, reverse=False),
                      lstm_scan(params_bwd, x, lengths, reverse=True)], dim=-1)
