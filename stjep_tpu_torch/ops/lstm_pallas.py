"""K1: fused bidirectional LSTM layer (port of stjep_tpu/ops/lstm_pallas.py
`bilstm_pallas`).

On a CUDA tensor the wrapper runs the input projections as one GEMM per
direction and the whole time sweep of both directions in one launch of
`csrc/bilstm.cu` (design notes there). On a CPU tensor it runs
`bilstm_plain`, the same function in plain PyTorch. Inference only: the
CUDA route has no backward and refuses inputs that require grad; the
trainable variant is K8, `lstm_pallas_bwd.bilstm_pallas_trainable`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch import kernels
from stjep_tpu_torch.ops.lstm import bilstm


def bilstm_plain(params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, T, Din] -> [B, T, 2H]."""
    return bilstm(params_fwd, params_bwd, x, lengths)


def bilstm_pallas(params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, Din] -> [B, T, 2H] with packed-length semantics."""
    if not x.is_cuda:
        return bilstm_plain(params_fwd, params_bwd, x, lengths)
    kernels.refuse_grad("bilstm_pallas", "bilstm_pallas_trainable "
                        "(ops/lstm_pallas_bwd.py)", x, *params_fwd.values(),
                        *params_bwd.values())
    B, T, Din = x.shape
    H = params_fwd["w_hh"].shape[0]
    x2 = x.reshape(B * T, Din).contiguous()
    xp = [kernels.gemm(x2, p["w_ih"].contiguous(),
                       bias=(p["b_ih"] + p["b_hh"]).contiguous())
          for p in (params_fwd, params_bwd)]
    if lengths is None:
        lengths = torch.full((B,), T, device=x.device)
    lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, T, 2 * H), device=x.device, dtype=torch.float32)
    kernels.launch("bilstm_recurrent", xp[0], xp[1],
                   params_fwd["w_hh"].contiguous(),
                   params_bwd["w_hh"].contiguous(), lens, out, B, T, H)
    bilstm_pallas.launches += 1
    return out


bilstm_pallas.launches = 0
