"""Device ms a batch of the LAS kernels: K1 (the pyramid's cluster sweeps
and their input-projection GEMM) and K2 (the fused greedy decoder)."""

LAYER = "LAS"
UNIT = "ms"
MOVES = "decode_utt_per_s"
KERNELS = ("bilstm_kernel", "gemm_kernel", "splitk_reduce_kernel", "greedy_kernel")


def read(r):
    ms = r.kernel_ms(KERNELS)
    return ms / r.units if ms else None
