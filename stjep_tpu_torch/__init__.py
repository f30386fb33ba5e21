"""stjep_tpu_torch — the PyTorch + CUDA (Hopper) port of stjep_tpu.

Mirrors the JAX package's layout (`ops/`, `models/`, `infer/`) and function
names, keeps its `[in, out]` weight layout and parameter key paths, and
replaces each Pallas TPU kernel on the ported path with a hand-written CUDA
kernel (`csrc/`, built by `kernels.py` at first use). Every kernel wrapper
routes a CPU tensor to the kernel's plain PyTorch version and launches the
CUDA kernel for a CUDA tensor.

This package imports neither JAX nor the JAX package: `config.py` holds
its own copy of the token ids and `ModelConfig`, pinned equal to
`stjep_tpu.config` by the tests.
"""

__version__ = "0.1.0"

from stjep_tpu_torch.config import BOS, EOS, PAD, SPC, UNK  # noqa: F401
