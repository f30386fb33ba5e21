"""Device ms a step of every kernel that is not the port's own (cuBLAS and
PyTorch's kernels: the transformer, the heads, the LSTM weight gradients,
Adam); copies and memsets left out."""

from perfbench.tracing import is_copy

LAYER = "transformer and optimizer"
UNIT = "ms"
MOVES = "train_samples_per_s"
OWN = ("bilstm_kernel", "bilstm_bwd_kernel", "gemm_kernel", "splitk_reduce_kernel",
       "greedy_kernel", "tf_fwd_kernel", "tf_bwd_kernel", "chain_kernel", "beam_kernel",
       "layer_kernel", "head_full_kernel", "head_step_kernel", "self_step_kernel",
       "cross_step_kernel", "ffn_step_kernel", "beam_select_kernel")


def read(r):
    ms = sum(v for k, v in r.device_ms.items() if k not in OWN and not is_copy(k))
    return ms / r.units if ms else None
