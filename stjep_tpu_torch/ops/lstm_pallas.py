"""K1: fused bidirectional LSTM layer (port of stjep_tpu/ops/lstm_pallas.py
`bilstm_pallas`).

On a CUDA tensor the wrapper runs the input projections as one GEMM per
direction and the whole time sweep of both directions in one launch of
`csrc/bilstm.cu`: one thread-block cluster per (batch tile, direction),
W_hh split across the cluster's blocks (design notes there). On a CPU
tensor it runs `bilstm_plain`, the same function in plain PyTorch.
Inference only: the CUDA route has no backward and refuses inputs that
require grad; the trainable variant is K8,
`lstm_pallas_bwd.bilstm_pallas_trainable`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.ops.lstm import bilstm

MAX_HIDDEN = 1024  # 64 units a block in clusters of 16 (csrc/bilstm.cu)


def sweep_shape(B: int, H: int, backward: bool = False) -> Tuple[int, int]:
    """(BT, C) of the cluster sweeps (K1, K8 forward and backward) at batch
    B and width H: batch rows per tile and blocks per cluster, chosen from
    the shape alone (the fastest pairs of `scripts/bilstm_tune.py` at H =
    256, PERF.md). Raises for a width the kernels do not take."""
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"the BiLSTM sweep kernels take 1 <= H <= {MAX_HIDDEN}, got {H}")
    if backward:
        return (8 if B <= 32 else 16), 16
    return (4 if B <= 16 else 8 if B <= 32 else 16), (8 if H <= 512 else 16)


def sweep_plan(B: int, H: int, backward: bool = False,
               shape: Optional[Tuple[int, int]] = None) -> Dict[str, int]:
    """What the sweep launches at (B, H): bt, c, blocks, threads a block,
    shared memory bytes, w_hh (where each block keeps its W_hh slice:
    "shared" memory, or "streamed" from L2 every step) and
    max_clusters (how many of its clusters the card holds at once). Asks
    the card; launches nothing."""
    bt, c = shape or sweep_shape(B, H, backward)
    info = (ctypes.c_int * 4)()
    kernels.launch("bilstm_bwd_plan" if backward else "bilstm_fwd_plan", B, H, bt, c,
                   ctypes.addressof(info))
    return dict(bt=bt, c=c, blocks=2 * c * -(-B // bt), threads=info[0], smem=info[1],
                w_hh=("shared", "streamed")[info[2] - 1], max_clusters=info[3])


def bilstm_plain(params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T, Din] -> [B, T, 2H]."""
    return bilstm(params_fwd, params_bwd, x, lengths)


def input_projections(x: torch.Tensor, w_ih, bias) -> list:
    """x @ W_ih + b of both directions on the card's GEMM: [B * T, 4H] each."""
    B, T, Din = x.shape
    x2 = x.reshape(B * T, Din).contiguous()
    return [kernels.gemm(x2, w.contiguous(), bias=b.contiguous()) for w, b in zip(w_ih, bias)]


def bilstm_pallas(params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, Din] -> [B, T, 2H] with packed-length semantics."""
    if not x.is_cuda:
        return bilstm_plain(params_fwd, params_bwd, x, lengths)
    kernels.refuse_grad("bilstm_pallas", "bilstm_pallas_trainable "
                        "(ops/lstm_pallas_bwd.py)", x, *params_fwd.values(),
                        *params_bwd.values())
    B, T, _ = x.shape
    H = params_fwd["w_hh"].shape[0]
    shape = sweep_shape(B, H)
    pf, pb = params_fwd, params_bwd
    xp = input_projections(x, (pf["w_ih"], pb["w_ih"]),
                           (pf["b_ih"] + pf["b_hh"], pb["b_ih"] + pb["b_hh"]))
    if lengths is None:
        lengths = torch.full((B,), T, device=x.device)
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, T, 2 * H), device=x.device, dtype=torch.float32)
    kernels.launch("bilstm_recurrent", xp[0], xp[1], pf["w_hh"].contiguous(),
                   pb["w_hh"].contiguous(), lens, out, B, T, H, *shape)
    bilstm_pallas.launches += 1
    return out


bilstm_pallas.launches = 0
