"""The program's spans in a traced stretch: the ranges that
stjep_tpu_torch/utils/profiling.py `span` opens while the profiler runs,
which the Chrome trace holds as `user_annotation` host events on the clock
of the card's operations (`Reading._host`, beside the host operators). A
decode request is `stjep.decode` (its LAS pass `.las`, its encoder
`.encoder`, its beam `.beam_loop` and, inside that, one `.flag_read` a
position); a train step is `stjep.train.step` (its `.forward`, `.backward`
and `.optimizer`). Readers match the names exactly; a program without a
span gives no interval and its readers None."""

from __future__ import annotations

from typing import List, Tuple

DECODE = "stjep.decode"
BEAM_LOOP = "stjep.decode.beam_loop"
FLAG_READ = "stjep.decode.flag_read"
TRAIN_FORWARD = "stjep.train.forward"
TRAIN_BACKWARD = "stjep.train.backward"
TRAIN_OPTIMIZER = "stjep.train.optimizer"

Interval = Tuple[float, float]


def intervals(r, name: str) -> List[Interval]:
    """The (start, end) us of every span `name` in the stretch, in order."""
    return [(s, e) for s, e, n in r._host if n == name]


def total_us(ivs: List[Interval]) -> float:
    """The intervals' summed duration in us."""
    return sum(e - s for s, e in ivs)


def union(ivs: List[Interval]) -> List[Interval]:
    """Disjoint sorted intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The time in both unions, as disjoint sorted intervals."""
    a, b = union(a), union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_us(r, inside: List[Interval], outside: List[Interval] = ()) -> float:
    """Device idle time (us) within `inside` and not within `outside`: the
    part of Reading.gaps() that overlaps the one and not the other."""
    within = intersect(r.gaps(), inside)
    return total_us(within) - total_us(intersect(within, list(outside)))
