"""The train step's model FLOPs (yardstick.analytic_train_flop_parts with
each row's valid frames for the pyramid, or mt_train_flop_parts) over the
traced steps' wall time, as a share of the H100's float32 peak (67 TFLOP/s;
the card's power limit is in the result's device entry)."""

from perfbench.yardstick import PEAK

LAYER = "the whole step"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(r):
    f = r.extra.get("flops")
    return None if not f else 100.0 * f / (r.wall_ms / 1e3) / PEAK["f32"]
