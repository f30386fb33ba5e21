"""The span readers (perfbench/spans.py and the six metrics that read the
program's spans) on a hand-made trace: their values computed by hand, None
where the spans are missing, and the spans left out of the host operator
count and the busy time."""

from __future__ import annotations

import pytest

from perfbench import registry, spans
from perfbench.tracing import Reading

DECODE_METRICS = ("entry_idle_ms.decode", "beam_idle_us.decode", "position_issue_us.decode")
TRAIN_METRICS = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")


def ev(cat, name, t0, t1):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


def span(name, t0, t1):
    return ev("user_annotation", name, t0, t1)


def kernels(*ivs):
    return [ev("kernel", "beam_kernel", a, b) for a, b in ivs]


# Two decode requests (us). Device gaps: (250, 280) 30, (430, 450) 20,
# (600, 620) 20, (900, 930) 30, (980, 1010) 30, (1400, 1450) 50, (1980, 2050) 70.
# Inside a request and outside its beam loop: 30 + 10 (430-440) + 30 (980-1010)
# + 50 + 10 (1990-2000) = 130 us; inside a beam loop: 10 (440-450) + 20 + 30
# + 10 (1980-1990) = 70 us; 2000-2050 lies in no request.
DECODE = (
    kernels((20, 250), (280, 430), (450, 600), (620, 900), (930, 980), (1010, 1400),
            (1450, 1980), (2050, 2100))
    + [span("stjep.decode", 0, 1000), span("stjep.decode.las", 10, 300),
       span("stjep.decode.encoder", 300, 420), span("stjep.decode.beam_loop", 440, 950),
       span("stjep.decode.flag_read", 500, 560), span("stjep.decode.flag_read", 700, 760),
       span("stjep.decode.flag_read", 900, 940),
       span("stjep.decode", 1000, 2000), span("stjep.decode.las", 1005, 1300),
       span("stjep.decode.encoder", 1300, 1480), span("stjep.decode.beam_loop", 1500, 1990),
       span("stjep.decode.flag_read", 1600, 1650), span("stjep.decode.flag_read", 1900, 1950),
       ev("cpu_op", "aten::add", 520, 530), ev("cuda_runtime", "cudaStreamSynchronize", 505, 555),
       ev("gpu_user_annotation", "stjep.decode", 0, 1000)])

# Two train steps: forward 40 + 30, backward 40 + 50, optimizer 15 + 18 us.
TRAIN = (
    kernels((5, 60), (210, 290))
    + [span("stjep.train.step", 0, 100), span("stjep.train.forward", 0, 40),
       span("stjep.train.backward", 40, 80), span("stjep.train.optimizer", 80, 95),
       span("stjep.train.step", 200, 300), span("stjep.train.forward", 200, 230),
       span("stjep.train.backward", 230, 280), span("stjep.train.optimizer", 280, 298)])


def read(metric, events, units):
    return registry.reader(metric).read(Reading(events, 3.0, units))


@pytest.mark.parametrize("metric,want", [("entry_idle_ms.decode", 130 / 2 / 1e3),
                                         ("beam_idle_us.decode", 70 / 5),
                                         ("position_issue_us.decode", (1000 - 260) / 5)])
def test_decode_readers_by_hand(metric, want):
    assert read(metric, DECODE, 2) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [("forward_host_ms.train", 70 / 2 / 1e3),
                                         ("backward_host_ms.train", 90 / 2 / 1e3),
                                         ("optimizer_host_ms.train", 33 / 2 / 1e3)])
def test_train_readers_by_hand(metric, want):
    assert read(metric, TRAIN, 2) == pytest.approx(want)


@pytest.mark.parametrize("metric", DECODE_METRICS + TRAIN_METRICS)
def test_no_spans_no_value(metric):
    """A program without spans (the parent of the change that added them)
    reads None, never 0, and does not raise."""
    bare = [e for e in DECODE + TRAIN if e["cat"] != "user_annotation"]
    assert read(metric, bare, 2) is None
    assert read(metric, [], 2) is None


@pytest.mark.parametrize("metric", DECODE_METRICS)
def test_decode_readers_need_the_beam_spans(metric):
    """Without its beam loop or its flag reads a decode reader reads None."""
    for drop in ("stjep.decode.beam_loop", "stjep.decode.flag_read"):
        if metric == "entry_idle_ms.decode" and drop == "stjep.decode.flag_read":
            continue
        events = [e for e in DECODE if e["name"] != drop]
        got = read(metric, events, 2)
        if metric == "entry_idle_ms.decode":  # with no loop, all the request's idle
            assert got == pytest.approx((130 + 70) / 2 / 1e3)
        else:
            assert got is None


def test_spans_are_neither_host_operators_nor_busy_time():
    with_spans, bare = Reading(DECODE, 3.0, 2), Reading(
        [e for e in DECODE if "stjep" not in e["name"]], 3.0, 2)
    assert with_spans.host_ops == bare.host_ops == 1
    assert with_spans.busy_ms == bare.busy_ms
    assert with_spans.gaps() == bare.gaps()


def test_breakdown_names_idle_by_the_open_span():
    """The breakdown's idle gaps, named by no host operation without the
    spans, are named by the span open where each gap opens."""
    named = dict(Reading(DECODE, 3.0, 2).breakdown()["idle_gaps"])
    bare = dict(Reading([e for e in DECODE if "stjep" not in e["name"]], 3.0,
                        2).breakdown()["idle_gaps"])
    assert bare == {"(no host operation)": pytest.approx(250e-6)}
    # opening at 250 las, 430 and 980 the request, 600 and 1980 the loop,
    # 900 a flag read, 1400 the encoder
    assert named == {"stjep.decode.las": pytest.approx(30e-6),
                     "stjep.decode": pytest.approx(50e-6),
                     "stjep.decode.beam_loop": pytest.approx(90e-6),
                     "stjep.decode.flag_read": pytest.approx(30e-6),
                     "stjep.decode.encoder": pytest.approx(50e-6)}


def test_interval_helpers():
    assert spans.union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert spans.intersect([(0, 10)], [(2, 3), (8, 12)]) == [(2, 3), (8, 10)]
    assert spans.intersect([(0, 1)], [(1, 2)]) == []
    assert spans.total_us([(0, 3), (5, 7)]) == 5
