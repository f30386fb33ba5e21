"""Build, load and launch the hand-written Hopper kernels in `csrc/`.

Each source compiles with its own `nvcc` process, all started together,
and one more `nvcc` links the objects into a shared library with a plain
C interface (`-gencode arch=compute_90a,code=sm_90a`), loaded with ctypes.
The build runs at first use, never at import: hosts without `nvcc` (the CPU
test lane) import this module freely. The library's file name carries a
digest of the sources and flags, so an edited source never loads a stale
build.

Launch helpers below take CUDA tensors, check device, dtype and contiguity,
allocate outputs with `torch.empty`, and launch on the current stream
without synchronising. Every C entry point returns `cudaGetLastError()`;
a non-zero code raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

SRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# C signatures: p = pointer (c_void_p), i = int, f = float. Every entry point
# also takes the stream last (c_void_p) and returns a cudaError_t.
_SIGS = {
    "gemm_f32": "pppppp" + "iiiiiiiii",
    "bilstm_recurrent": "pppppp" + "iii" + "ii",
    "bilstm_fwd_save": "pppppp" + "ppp" + "iii" + "ii",
    "bilstm_bwd_recurrent": "ppppppp" + "iii" + "ii",
    "bilstm_fwd_plan": "iiii" + "p",
    "bilstm_bwd_plan": "iiii" + "p",
    "beam_select": "pppppppp" + "pppppppp" + "iiii" + "f",
    "decoder_layer_fused": "p" + "ii" + "p" * 11 + "i" * 11,
    "decode_beam_fused": "p" + "ii" + "p" * 27 + "i" * 14 + "f",
    "decode_chain_fused": "p" + "ii" + "p" * 17 + "i" * 14,
    "self_attn_step_fused": "p" * 14 + "i" * 12,
    "cross_attn_step_fused": "p" * 11 + "i" * 11,
    "ffn_step_fused": "p" * 10 + "i" * 7,
    "head_partial_fused": "p" * 12 + "i" * 7,
    "head_fused": "p" * 10 + "i" * 7,
    "decode_fused_grid": "iiii" + "p",
    "decode_fused_stamps": "p",
    "decode_chain_grid": "iiii" + "p",
    "decode_chain_stamps": "p",
    "las_greedy_fused": "p" * 16 + "i" * 14,
    "las_tf_fwd_fused": "p" * 21 + "i" * 11,
    "las_tf_bwd_fused": "p" * 18 + "i" * 11,
    "las_fused_grid": "ii" + "p",
    "las_fused_stamps": "pp",
}
_CT = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lib = None
_fns = {}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libstjep_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every (name, Popen) and raise on the first failure."""
    errors = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name} failed ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists: one nvcc
    per source in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        _run(procs)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, sig in _SIGS.items():
            fn = getattr(handle, name)
            fn.argtypes = [_CT[c] for c in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        _lib = handle
    return _lib


def launch(name: str, *args):
    if not _fns:
        lib()
    rc = _fns[name](*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def refuse_grad(name: str, route: str, *tensors):
    """Raise when autograd would record through a CUDA route that has no
    backward: its outputs come from ctypes launches into `torch.empty`
    buffers and carry no grad_fn, so gradients would stop there silently
    (the same call on CPU tensors goes through plain PyTorch and does
    produce them). `route` names what to call under autograd instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; under autograd use {route}, or call it under "
            "torch.no_grad()")


def check(t: torch.Tensor, dtype=torch.float32, name: str = "tensor"):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


# ---------------------------------------------------------------------------
# the shared building block: tiled GEMM with bias / ReLU / residual
# ---------------------------------------------------------------------------


def gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
         residual: Optional[torch.Tensor] = None, relu: bool = False,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[M, N] = act(a[M, K] @ w[K, N] + bias) + residual, in f32 on the
    card. `a`, `residual` and `out` may be row-strided 2-D views (unit
    stride along the last dim); `w` and `bias` are contiguous."""
    M, K = a.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"gemm inner dims differ: {a.shape} @ {w.shape}")
    if not a.is_cuda or a.dtype != torch.float32 or a.stride(-1) != 1:
        raise ValueError("gemm a must be a CUDA f32 matrix with unit column stride")
    check(w, name="w")
    if bias is not None:
        check(bias, name="bias")
    if out is None:
        out = torch.empty((M, N), device=a.device, dtype=torch.float32)
    if out.stride(-1) != 1 or (residual is not None and residual.stride(-1) != 1):
        raise ValueError("gemm out/residual need unit column stride")
    # split K across blocks when the output tiles alone cannot fill the card
    # (two blocks per SM), keeping at least 4 K tiles of 16 per split
    tiles = -(-N // 64) * -(-M // (16 if M <= 32 else 64))
    splits = max(1, min(-(-264 // tiles), -(-K // 16) // 4))
    ws = (torch.empty((splits, M, N), device=a.device, dtype=torch.float32)
          if splits > 1 else None)
    launch("gemm_f32", a, w, bias, residual, out, ws, M, N, K, a.stride(0), w.stride(0),
           out.stride(0), residual.stride(0) if residual is not None else 0,
           int(relu), splits)
    return out
