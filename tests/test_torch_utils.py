"""The port's utility modules against the JAX package's
(stjep_tpu_torch/utils/profiling.py, trace_tools.py, plotting.py), on the
CPU: StepTimer's summary, memory_stats, a torch.profiler trace found and
read back, the trace readings on a synthetic Chrome trace with overlapping
intervals, and the plots' pixels."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from stjep_tpu.utils import plotting as jplotting
from stjep_tpu.utils.profiling import StepTimer as JStepTimer

from stjep_tpu_torch.utils import plotting, profiling, trace_tools


@pytest.mark.parametrize("laps", [[], [0.5], [2.0, 0.1, 0.3, 0.2, 0.25], [1.0, 0.4, 0.4]])
def test_step_timer_summary_matches_jax(laps):
    t, j = profiling.StepTimer(), JStepTimer()
    t.times, j.times = list(laps), list(laps)
    assert t.summary() == j.summary()


def test_step_timer_forces_one_element():
    t = profiling.StepTimer()
    for leaf in (torch.ones(4, 3), np.ones(3), None):
        t.start()
        assert t.stop(leaf) >= 0
    assert t.summary()["steps"] == 3


def test_memory_stats_reads_the_host_rss():
    s = profiling.memory_stats()
    assert s["host_rss_mb"] > 0
    assert not any(k.startswith("device") for k in s) or torch.cuda.is_available()


def test_trace_writes_what_latest_trace_file_finds(tmp_path):
    """On the CPU: the trace holds the body's host operators, no device
    event, and an envelope per profiler step."""
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(2):
            torch.ones(64, 64) @ torch.ones(64, 64)
            prof.step()
    path = trace_tools.latest_trace_file(str(tmp_path))
    assert path.endswith(".pt.trace.json.gz") and "plugins/profile" in path
    with gzip.open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert trace_tools.device_events(str(tmp_path)) == []
    assert trace_tools.op_table(str(tmp_path)) == []
    assert trace_tools.window_breakdown(str(tmp_path))["op_ms"] == 0.0
    with pytest.raises(FileNotFoundError):
        trace_tools.latest_trace_file(str(tmp_path / "none"))


def _write_trace(root, events):
    d = root / "plugins" / "profile" / "2026_01_01_00_00_00_000000"
    d.mkdir(parents=True)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_readings_of_a_synthetic_trace(tmp_path):
    """Kernels a and b overlap, a copy and a set beside them, a host
    operator that must not count, and two profiler steps on the stream
    (host spans too, which the stream's replace). Step 1 [0, 100) holds a
    [10, 40) and b [30, 60): 50 us busy; step 2 [100, 200) holds a copy
    [120, 130), a set [125, 140) and a kernel [190, 210) cut at 200: 30 us."""
    X = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,  # noqa: E731
                                    "ts": ts, "dur": dur, "pid": 1, "tid": 7}
    _write_trace(tmp_path, [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "gpu"}},
        X("ProfilerStep#0", "user_annotation", -5, 300),
        X("ProfilerStep#0", "gpu_user_annotation", 0, 100),
        X("ProfilerStep#1", "gpu_user_annotation", 100, 100),
        X("kernel_a", "kernel", 10, 30), X("kernel_b", "kernel", 30, 30),
        X("Memcpy HtoD", "gpu_memcpy", 120, 10), X("Memset", "gpu_memset", 125, 15),
        X("kernel_a", "kernel", 190, 20), X("aten::mm", "cpu_op", 0, 500)])
    evs = trace_tools.device_events(str(tmp_path))
    assert [e["ts"] for e in evs] == [10, 30, 120, 125, 190]
    table = trace_tools.op_table(str(tmp_path))
    assert table[0] == {"name": "kernel_a", "total_ms": 0.05, "count": 2, "mean_us": 25.0}
    assert [r["name"] for r in table] == ["kernel_a", "kernel_b", "Memset", "Memcpy HtoD"]
    assert trace_tools.op_table(str(tmp_path), top=1, exclude_prefixes=("kernel_",)) == [
        {"name": "Memset", "total_ms": 0.015, "count": 1, "mean_us": 15.0}]
    assert trace_tools.window_breakdown(str(tmp_path)) == {
        "programs": 2, "program_ms": 0.2, "op_ms": 0.08, "gap_ms": 0.12}
    assert trace_tools.busy_union_ms([(10, 40), (30, 60), (120, 130), (125, 140),
                                      (190, 210), (55, 58)]) == pytest.approx(0.09)
    assert trace_tools.busy_union_ms([]) == 0.0


@pytest.mark.parametrize("which", ["alignment", "attention"])
def test_plots_are_the_jax_packages_pixels(tmp_path, which):
    import matplotlib.image as mpimg

    att = np.random.RandomState(3).rand(5, 6)
    paths = {}
    for tag, mod in (("port", plotting), ("jax", jplotting)):
        paths[tag] = str(tmp_path / f"{tag}.png")
        if which == "alignment":
            mod.plot_alignment(att, paths[tag], src=list("abcdef"), hyp=list("vwxyz"),
                               ref=list("abc"))
        else:
            mod.plot_attention(att, paths[tag], words=list("abcde"), words_right=list("vwxyz"))
    a, b = mpimg.imread(paths["port"]), mpimg.imread(paths["jax"])
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_array_equal(a, b)
    assert os.path.getsize(paths["port"]) > 1000
