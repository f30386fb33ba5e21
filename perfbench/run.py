"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (stjep_tpu_torch) and
BENCHMARK.json. Set-up draws the weights on the card from the seed, makes
the host pool of batches, and warms up the cell's shapes (the first run in
a checkout also builds the program's kernels into stjep_tpu_torch/build/).
With --trace 0 it measures the cell's end-to-end metrics over --seconds;
with --trace 1 it runs a stretch of `trace_units` calls under
torch.profiler and reports the per-layer metrics. Either way it then holds
what the timed calls produced to the plain reference (perfbench/checks.py)
and prints each number compared beside its limit on standard error, and
the result as the last line of standard output. Without enough CUDA cards,
or with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "stjep_tpu")


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (stjep_tpu_torch is the program and is allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run's settings and what its parts share."""

    def __init__(self, bench, cell, seed, seconds, trace, device):
        from perfbench import registry, yardstick

        self.bench, self.cell, self.seed = bench, cell, int(seed)
        self.seconds, self.trace = float(seconds), int(trace)
        self.config = registry.config(bench, cell["config"])
        self.model = self.config["model"]
        self.traffic = registry.traffic(cell["traffic"])
        self.limits = registry.limits(cell["name"])
        self.yardstick = yardstick
        self.device = device
        self.check_seconds = 0.0  # set-up time spent only on the comparison's readings


def device_info(torch, device, chips: int) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type, "count": chips}
    if device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(device)
        limit = power_limit()
        if limit is not None:
            info["power_limit_w"] = limit
    return info


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def traced(run, entry, st, torch):
    """The stretch under the profiler and the per-layer metrics it gives."""
    from perfbench import registry, tracing
    from perfbench.tracing import Recorder
    from stjep_tpu_torch.utils.profiling import zero_launch_counts

    metrics = registry.metrics_of(run.bench, run.cell["name"], "per_layer")
    readers = {m["name"]: registry.reader(m["name"]) for m in metrics}
    hooks = {}
    for r in readers.values():
        w = getattr(r, "WORK", None)
        if w and w not in hooks:
            spec = registry.work(w)
            counter = registry.count(spec["count"])
            rec = None
            if spec.get("hook"):
                mod, attr = spec["hook"].rsplit(".", 1)
                rec = Recorder(importlib.import_module(mod), attr, keep=counter.keep)
            hooks[w] = (spec, counter, rec)
    n = run.traffic["trace_units"]
    for _ in range(n):  # the hooks' own allocations, made before the stretch
        entry.call(run, st)
    for _, _, rec in hooks.values():
        if rec is not None:
            rec.calls.clear()
    zero_launch_counts()
    sync = (lambda: torch.cuda.synchronize(run.device)) if run.device.type == "cuda" else (
        lambda: None)
    wall = {}

    def body():
        t0 = time.perf_counter()
        for _ in range(n):
            entry.call(run, st)
        sync()
        wall["ms"] = (time.perf_counter() - t0) * 1e3

    events = tracing.profile(body)
    extra = entry.stretch_extra(run, st, n)
    work = {}
    for w, (spec, counter, rec) in hooks.items():
        if rec is not None:
            rec.remove()
            nb, fl = counter.count(rec.calls, run.model) if rec.calls else (0, 0)
        else:
            nb, fl = counter.stretch(run, st, n) or (0, 0)
        if fl or nb:
            work[w] = {**run.yardstick.bound(nb, fl), "kernels": spec["kernels"]}
    extra["work"] = work
    reading = tracing.Reading(events, wall["ms"], n, extra)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(reading)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    return values, reading


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is missing or not finite fails."""
    import math

    out, ok = {}, True
    for name, lim in limits["limits"].items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        out[name] = {"value": v, "limit": lim}
    return ok, out


def execute(workload: str, seed: int, seconds: float, trace: int, device_name: str = "cuda",
            bench=None):
    """The run; returns the result dict (raises Refused where there is none)."""
    from perfbench import registry

    bench = bench or registry.benchmark()
    cell = registry.cell(bench, workload)
    import torch

    if device_name == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"needs {cell['chips']} CUDA card(s); "
                          f"torch.cuda.is_available() is {torch.cuda.is_available()}")
    device = torch.device(device_name, 0) if device_name == "cuda" else torch.device(device_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    run = Run(bench, cell, seed, seconds, trace, device)
    entry = importlib.import_module(f"perfbench.entries.{run.traffic['entry']}")
    cuda = device.type == "cuda"

    st = entry.setup(run)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START - run.check_seconds
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    result = {"metrics": {}}
    e2e = {m["name"]: m for m in registry.metrics_of(bench, workload, "end_to_end")}
    if trace:
        values, reading = traced(run, entry, st, torch)
        result["metrics"] = values
        units, elapsed = reading.units, reading.wall_ms / 1e3
        busy = {"busy_s": reading.busy_ms / 1e3, "window_s": elapsed}
        breakdown = reading.breakdown()
    else:
        got = entry.window(run, st, run.seconds)
        units, elapsed = got["_units"], got["_elapsed"]
        got["setup_s"] = setup_s
        busy, breakdown = {}, None
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if not trace:
        got["peak_mem_gib"] = window_peak / 2 ** 30
        for name, m in e2e.items():
            if name in got:
                result["metrics"][name] = {"value": got[name], "unit": m["unit"]}
    bad = loaded_forbidden()
    if bad:
        raise Refused(f"JAX or the JAX package is loaded: {', '.join(bad)}")
    for key in ("opt", "step"):
        st.pop(key, None)
    if cuda:
        torch.cuda.empty_cache()
    numbers = entry.check(run, st)
    ok, shown = judge(numbers, run.limits)
    info = device_info(torch, device, cell["chips"])
    info["memory_peak_bytes"] = max(setup_peak, window_peak) if cuda else 0
    info.update(busy)
    result = {"correct": ok, "attempted": units * (run.traffic["batch"]
                                                   if entry.UNIT == "batch" else 1),
              "failed": 0, "metrics": result["metrics"], "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["seconds"] = elapsed
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = execute(a.workload, a.seed, a.seconds, a.trace)
    except Refused as e:
        print(f"perfbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
