"""The traced run's reading: a stretch of the cell's own calls under
torch.profiler (host operators and the card's operations), reduced to
what the per-layer readers take. The reduction is the benchmark's own: the
busy union (yardstick.busy_union_ms), the host `aten::` operators, the
device ms by kernel name, and the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import functools
import inspect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

from perfbench.yardstick import busy_union_ms


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


def base_name(name: str) -> str:
    """A device operation's name without namespaces, template arguments and
    parameters: "void (anonymous namespace)::bilstm_kernel<true>(float*)"
    -> "bilstm_kernel"; a copy keeps its kind ("Memcpy HtoD")."""
    if is_copy(name):
        return name.split(" (")[0]
    n = name.replace("(anonymous namespace)::", "").split("(")[0]
    n = re.sub(r"<.*>", "", n).strip()
    return n.split("::")[-1].split()[-1] if n else name


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Reading:
    """The stretch: its wall ms on the host clock, its units (batches or
    steps) and whatever the entry adds (`extra`), and from the profiler the
    device operations' intervals by base name and the host operators."""

    def __init__(self, events: List[Dict], wall_ms: float, units: int,
                 extra: Optional[Dict] = None):
        self.wall_ms, self.units, self.extra = wall_ms, units, extra or {}
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
        host = [e for e in spans if e.get("cat") in HOST_CATS]
        self.intervals = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
        self.busy_ms = busy_union_ms(self.intervals)
        self.device_ms: Dict[str, float] = defaultdict(float)
        for e in dev:
            self.device_ms[base_name(e["name"])] += float(e["dur"]) / 1e3
        self.host_ops = sum(1 for e in host
                            if e["cat"] == "cpu_op" and e["name"].startswith("aten::"))
        self._host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                            for e in host)

    def kernel_ms(self, names: Iterable[str]) -> float:
        return sum(self.device_ms.get(n, 0.0) for n in names)

    def roofline(self, work: str) -> Optional[float]:
        """100 x the least time of the stretch's `work` (extra["work"]) over
        the device ms of the kernels that do it; None without either."""
        w = self.extra.get("work", {}).get(work)
        ms = self.kernel_ms(w["kernels"]) if w else 0.0
        return 100.0 * w["bound_ms"] / ms if ms else None

    def idle_share(self) -> Optional[float]:
        return 1.0 - self.busy_ms / self.wall_ms if self.intervals else None

    def gaps(self) -> List[tuple]:
        """Idle gaps between the merged device intervals, (start, end) us."""
        out, end = [], None
        for a, b in self.intervals:
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def breakdown(self, n: int = 10) -> Dict:
        """The device operations that took most time, and the idle gaps'
        seconds by the innermost host operation running where each opens."""
        ops = sorted(((k, v / 1e3) for k, v in self.device_ms.items()), key=lambda kv: -kv[1])
        starts = [h[0] for h in self._host]
        by_host: Dict[str, float] = defaultdict(float)
        for g0, g1 in self.gaps():
            i = bisect.bisect_right(starts, g0) - 1
            name = "(no host operation)"
            while i >= 0:
                s, e, nm = self._host[i]
                if e >= g0:
                    name = nm
                    break
                i -= 1
                if g0 - s > 1e6:  # nothing open within a second before the gap
                    break
            by_host[name] += (g1 - g0) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:n]],
                "idle_gaps": [[k, v] for k, v in idle[:n]]}


class Recorder:
    """Wraps a module attribute so each call leaves a record: its result,
    or what `keep(args, out)` takes from the call, with `args` the call's
    arguments bound to the wrapped function's parameter names (readers
    take them by name, never by position). `keep` returns references or
    small values, read after the call; it raises ValueError where the
    function no longer has what it reads."""

    def __init__(self, module, name: str, keep: Optional[Callable] = None):
        self.module, self.name, self.keep = module, name, keep
        self.inner = getattr(module, name)
        self.signature = inspect.signature(self.inner) if keep else None
        self.calls: List = []
        rec = self

        @functools.wraps(self.inner)  # a second hook on it binds the same names
        def wrapped(*a, **kw):
            out = rec.inner(*a, **kw)
            if rec.keep is None:
                rec.calls.append(out)
            else:
                bound = rec.signature.bind(*a, **kw)
                bound.apply_defaults()
                rec.calls.append(rec.keep(bound.arguments, out))
            return out

        setattr(module, name, wrapped)

    def remove(self):
        setattr(self.module, self.name, self.inner)


def arg(args: Dict, name: str, ndim: Optional[int] = None, dtype=None):
    """A recorded call's argument `name`, checked: a ValueError, not a wrong
    count, where the hooked function no longer takes it as a tensor of
    `ndim` dimensions and `dtype`."""
    if name not in args:
        raise ValueError(f"the hooked function has no argument {name!r} "
                         f"(it takes {', '.join(args)})")
    v = args[name]
    if ndim is not None and (getattr(v, "ndim", None) != ndim
                             or (dtype is not None and v.dtype != dtype)):
        raise ValueError(f"argument {name!r} is not a {ndim}-d {dtype or 'tensor'}: "
                         f"{type(v).__name__} {getattr(v, 'shape', '')} {getattr(v, 'dtype', '')}")
    return v


def result(out, index: int, ndim: int, dtype=None):
    """Item `index` of a recorded call's result tuple, checked as `arg` checks."""
    v = out[index] if isinstance(out, (tuple, list)) and len(out) > index else None
    if getattr(v, "ndim", None) != ndim or (dtype is not None and v.dtype != dtype):
        raise ValueError(f"result item {index} is not a {ndim}-d {dtype or 'tensor'}: "
                         f"{type(v).__name__} {getattr(v, 'shape', '')}")
    return v


def profile(fn) -> List[Dict]:
    """Run fn() under torch.profiler (host and card) and return the trace's
    events, read from its Chrome trace, written to a temporary file under
    TMPDIR and removed."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
