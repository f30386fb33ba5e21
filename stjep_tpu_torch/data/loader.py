"""Fast batch materialisation and prefetch (port of
stjep_tpu/data/loader.py).

- `NativeLoader`: ctypes binding to the C++ fastloader
  (`data/native/fastloader.cpp`, a copy of the JAX package's: npy parse +
  CMVN + pad in a thread pool), replacing the per-utterance Python np.load
  loop (ref: utils/dataset.py:157-184). It is built with g++ (or c++,
  clang++) at first use into `stjep_tpu_torch/build/`, never at import;
  `get_native_loader` returns None when no compiler is found, and the
  dataset then takes the numpy path. `NativeLoader.calls` counts the
  batches it loaded.
- `host_prefetch`: a background thread that runs an iterator ahead of its
  consumer.
- `prefetch_to_device`: host_prefetch over batches copied into pinned host
  memory and on to the device with non-blocking copies, so the transfer
  overlaps the previous step's compute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_SRC = Path(__file__).with_name("native") / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]


def library_path() -> Path:
    """The built library; its name carries a digest of the source and
    flags, so an edited source never loads a stale build."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libfastloader_{h.hexdigest()[:16]}.so"


def _ensure_built() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for cxx in ("g++", "c++", "clang++"):
        try:
            subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        os.replace(tmp, out)
        return out
    return None


class NativeLoader:
    """Threaded native npy batch loader with CMVN + pad-to-T."""

    calls = 0  # batches loaded through the native library, all instances

    def __init__(self):
        so = _ensure_built()
        self._lib = None
        if so is not None:
            lib = ctypes.CDLL(str(so))
            lib.stjep_load_batch.restype = ctypes.c_int
            lib.stjep_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
            ]
            self._lib = lib

    @property
    def available(self) -> bool:
        return self._lib is not None

    def load_batch(self, paths, T: int, D: int, norm_param=None) -> np.ndarray:
        """Load utterances into a zero-padded [n, T, D] float32 array."""
        n = len(paths)
        out = np.empty((n, T, D), dtype=np.float32)
        lens = (ctypes.c_long * n)()
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        mus = stds = None
        stat_dim = 0
        if norm_param is not None:
            mus_np = [np.ascontiguousarray(m[:D], dtype=np.float32)
                      for m, s in norm_param]
            stds_np = [np.ascontiguousarray(s[:D], dtype=np.float32)
                       for m, s in norm_param]
            mus = (ctypes.c_void_p * n)(
                *[m.ctypes.data_as(ctypes.c_void_p).value for m in mus_np])
            stds = (ctypes.c_void_p * n)(
                *[s.ctypes.data_as(ctypes.c_void_p).value for s in stds_np])
            stat_dim = D
        rc = self._lib.stjep_load_batch(
            ctypes.cast(c_paths, ctypes.POINTER(ctypes.c_char_p)), n,
            ctypes.cast(mus, ctypes.POINTER(ctypes.c_void_p)) if mus else None,
            ctypes.cast(stds, ctypes.POINTER(ctypes.c_void_p)) if stds else None,
            stat_dim, out.ctypes.data_as(ctypes.c_void_p), T, D, lens)
        if rc != 0:
            raise RuntimeError(
                f"fastloader failed on utterance {rc // 100} (code {rc % 100})")
        NativeLoader.calls += 1
        return out


_native_singleton: Optional[NativeLoader] = None


def get_native_loader() -> Optional[NativeLoader]:
    global _native_singleton
    if _native_singleton is None:
        _native_singleton = NativeLoader()
    return _native_singleton if _native_singleton.available else None


def host_prefetch(batch_iter, size: int = 2):
    """Background-thread host-side prefetch: overlaps npy I/O + batch
    assembly with device compute. Producer exceptions re-raise on the
    consumer side; abandoning the generator early (break / exception in the
    consumer) unblocks and stops the producer instead of leaving it parked
    on a full queue holding batches for the life of the process."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    err = []
    stop = threading.Event()

    def producer():
        try:
            for item in batch_iter:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            # deliver _END (the consumer may still be draining a full
            # queue); give up only once the consumer abandoned us
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                break
            yield item
    finally:
        stop.set()


def to_device(item: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch dict of numpy arrays as tensors on `device`: on a CUDA device
    through pinned host memory with non-blocking copies (ordered on the
    current stream, so a later kernel reads them complete)."""
    device = torch.device(device)
    out = {}
    for k, v in item.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def prefetch_to_device(batch_iter: Iterator[Dict[str, np.ndarray]],
                       size: int = 2, device="cuda") -> Iterator[Dict]:
    """Background-thread prefetcher: materialises host batches and stages
    them onto `device` ahead of consumption (`to_device`). Same
    error/abandonment semantics as host_prefetch."""
    return host_prefetch((to_device(item, device) for item in batch_iter),
                         size=size)
