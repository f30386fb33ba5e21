"""Reading torch.profiler traces: device time by operation, busy and idle
(port of stjep_tpu/utils/trace_tools.py).

Two sources. A Chrome trace on disk, as utils/profiling.py `trace` writes
it (`latest_trace_file`, `device_events`, `op_table`, `window_breakdown`:
JAX's four functions, with the card's streams in place of the TPU's
device track); and the events of a live profiler (`prof.events()`), which
the measurement scripts read: `device_ops`, `busy_union_ms`,
`profile_reading`.

Caveats: a hand-written kernel is one opaque event, its internals unseen;
device intervals cover only the time the card executed, so the gaps
inside an envelope are launch and host bubbles.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

# Chrome-trace categories of the work on the card's streams
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def latest_trace_file(logdir: str) -> str:
    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                          "*.trace.json.gz")))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {logdir}")
    return paths[-1]


def _events(logdir: str) -> List[dict]:
    with gzip.open(latest_trace_file(logdir)) as f:
        return json.load(f).get("traceEvents", [])


def device_events(logdir: str) -> List[dict]:
    """Complete ('X') events on the card's streams (kernels, copies and
    sets), sorted by ts."""
    out = [e for e in _events(logdir)
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort(key=lambda e: e["ts"])
    return out


def op_table(logdir: str, top: int = 0,
             exclude_prefixes: Tuple[str, ...] = ()) -> List[Dict]:
    """Device events by name -> rows sorted by total time, names starting
    with an exclude prefix dropped. Returns [{name, total_ms, count,
    mean_us}]."""
    per = defaultdict(lambda: [0.0, 0])
    for e in device_events(logdir):
        name = e.get("name", "?")
        if any(name.startswith(p) for p in exclude_prefixes):
            continue
        per[name][0] += e.get("dur", 0.0)
        per[name][1] += 1
    rows = [
        {"name": n, "total_ms": round(t / 1000.0, 3), "count": c,
         "mean_us": round(t / max(c, 1), 1)}
        for n, (t, c) in per.items()
    ]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top] if top else rows


def window_breakdown(logdir: str, envelope_prefix: str = "ProfilerStep#") -> Dict:
    """Occupancy inside the envelopes: the `record_function` ranges named
    '<envelope_prefix>*' (the profiler's steps by default), their span on
    the card's streams where the trace has it (category
    gpu_user_annotation), else on the host. Sums their duration, the
    device time inside them (the union of the device events, clipped to
    each envelope) and the residual gap (the card idle inside them)."""
    evs = _events(logdir)
    envs = [e for e in evs if e.get("ph") == "X"
            and e.get("name", "").startswith(envelope_prefix)]
    on_device = [e for e in envs if e.get("cat") == "gpu_user_annotation"]
    envs = on_device or envs
    inner = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in evs
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    env_span = sum(e["dur"] for e in envs)
    covered = 0.0
    for env in envs:
        s, t = env["ts"], env["ts"] + env["dur"]
        covered += 1e3 * busy_union_ms((max(a, s), min(b, t)) for a, b in inner
                                       if min(b, t) > max(a, s))
    return {
        "programs": len(envs),
        "program_ms": round(env_span / 1000.0, 3),
        "op_ms": round(covered / 1000.0, 3),
        "gap_ms": round((env_span - covered) / 1000.0, 3),
    }


def busy_union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total / 1e3


def device_ops(events) -> list:
    """The events of a live profiler (prof.events()) that ran on the card."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def short_name(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1].split()[-1]


def profile_reading(events, wall_ms: float) -> Dict:
    """The reading of a live profiler's events over a call of wall_ms: the
    device operations, the card's busy ms (the union of their intervals),
    the idle share (1 - busy / wall; None without device operations) and
    the host-side aten operators."""
    dev = device_ops(events)
    busy = busy_union_ms((e.time_range.start, e.time_range.end) for e in dev)
    return {"device_ops": len(dev), "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if dev else None,
            "host_aten_ops": sum(1 for e in events
                                 if e.device_type == torch.autograd.DeviceType.CPU
                                 and e.name.startswith("aten::"))}
