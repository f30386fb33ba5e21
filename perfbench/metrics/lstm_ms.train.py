"""Device ms a step of K8 (the trainable pyramid's sweeps, forward and
backward, and its input-projection GEMM) and K9 (the teacher-forced LAS
decoder, forward and backward)."""

LAYER = "LAS"
UNIT = "ms"
MOVES = "train_samples_per_s"
KERNELS = ("bilstm_kernel", "bilstm_bwd_kernel", "gemm_kernel", "splitk_reduce_kernel",
           "tf_fwd_kernel", "tf_bwd_kernel")


def read(r):
    ms = r.kernel_ms(KERNELS)
    return ms / r.units if ms else None
