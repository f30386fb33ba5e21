"""Profiling utilities (port of stjep_tpu/utils/profiling.py): the
reference's wall-clock prints and memory logging, on the card.

- `StepTimer`: per-step wall time with the device's work forced complete
- `trace`: a torch.profiler run written as a Chrome trace that
  utils/trace_tools.py reads
- `memory_stats`: the host process's RSS and each card's allocated bytes
- `launch_counters`: every hand-written kernel wrapper's launch counter
- `span`: a named range of the program's own (a decode request, a train
  step and their phases) in the trace of a running torch.profiler

JAX's `start_server` (a live profiling server for TensorBoard) has no
torch.profiler counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import resource
import socket
import time
from typing import Dict, Optional

import numpy as np
import torch


class StepTimer:
    """Wall-clock step timer that forces device completion per lap by
    reading one element of the step's result back (JAX's summary: the
    first lap, which builds the kernels, is dropped)."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result_leaf=None) -> float:
        if result_leaf is not None:
            # one element: reading the whole tensor would time its copy
            if torch.is_tensor(result_leaf):
                result_leaf.detach().reshape(-1)[:1].cpu()
            else:
                np.asarray(result_leaf).ravel()[:1].copy()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0, "steps": 0}
        arr = np.asarray(self.times[1:] or self.times)  # drop the build lap
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps": len(self.times),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (the host's operators, and the card's kernels and
    copies where a card is present) and write a Chrome trace to
    <log_dir>/plugins/profile/<time>/<host>.pt.trace.json.gz, the layout
    JAX's traces take, which trace_tools.latest_trace_file finds. Yields
    the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    now = time.time()
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime(now))
    out = os.path.join(log_dir, "plugins", "profile", f"{stamp}_{int(now % 1 * 1e6):06d}")
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"{socket.gethostname()}.pt.trace.json.gz"))


def memory_stats() -> Dict[str, float]:
    """The host process's resident set in MB (`host_rss_mb`; the peak where
    /proc/self/statm is missing) and, with a card, `device<i>_bytes_in_use`
    (torch.cuda.memory_allocated). utils/misc.py get_memory_alloc reads the
    card's peak instead."""
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out = {"host_rss_mb": rss / 2 ** 20}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"device{i}_bytes_in_use"] = torch.cuda.memory_allocated(i)
    return out


VARIANTS = ((False, False), (True, False), (False, True), (True, True))  # (int8, bf16)


def variant_label(quant: bool, bf16: bool) -> str:
    return "+".join(n for n, on in (("int8", quant), ("bf16", bf16)) if on) or "f32"


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the body as the range `name` (a fixed
    string under "stjep.") while a torch.profiler profile is running: a
    `record_function`, written to the Chrome trace as a `user_annotation`
    on the clock of the card's kernels and copies, nested under the span
    open on the same thread. With no profiler running it is one shared
    null context, which records and allocates nothing. Wrap a run in
    `trace(log_dir)` and open the trace in Perfetto to see them."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def launch_counters() -> Dict[str, tuple]:
    """Every kernel wrapper's launch counter: name -> (wrapper, attribute).
    A wrapper adds one where it launches its kernel, and nowhere else."""
    from stjep_tpu_torch.ops import decode_flash as df
    from stjep_tpu_torch.ops import las_tf_flash as k9
    from stjep_tpu_torch.ops import lstm_pallas_bwd as k8
    from stjep_tpu_torch.ops.las_flash import las_greedy_flash
    from stjep_tpu_torch.ops.lstm_pallas import bilstm_pallas

    out = {"K1": (bilstm_pallas, "launches"), "K2": (las_greedy_flash, "launches"),
           "K3 gather": (df.decode_chain_step_flash, "gather_launches"),
           "K4 select": (df.beam_select, "launches"),
           "K7 head": (df.decode_head, "launches"),
           "K7 head_gather": (df.decode_head_gather, "launches"),
           "K8 fwd": (k8.bilstm_fwd_save, "launches"), "K8 bwd": (k8.bilstm_bwd, "launches"),
           "K9 fwd": (k9.las_tf_fwd, "launches"), "K9 bwd": (k9.las_tf_bwd, "launches"),
           "self_attn bf16": (df.self_attn_step, "bf16_launches"),
           "cross_attn bf16": (df.cross_attn_step, "bf16_launches"),
           "K6 self_attn_step": (df.self_attn_step, "launches"),
           "K6 cross_attn_step": (df.cross_attn_step, "launches"),
           "K6 ffn_step": (df.ffn_step, "launches"),
           "K7 head_partial": (df.decode_head_partial, "launches")}
    for k, fn in (("K3", df.decode_chain_step_flash), ("K4", df.decode_beam_step_flash),
                  ("K5", df.decoder_layer_step_flash)):
        for quant, bf16 in VARIANTS:
            label = k if not (quant or bf16) else f"{k} {variant_label(quant, bf16)}"
            out[label] = (fn, ("q8_" if quant else "") + ("bf16_" if bf16 else "") + "launches")
    return out


def zero_launch_counts():
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def launch_counts() -> Dict[str, int]:
    """The counts since zero_launch_counts()."""
    return {k: getattr(fn, attr) for k, (fn, attr) in launch_counters().items()}
