"""The decode batch's model FLOPs (yardstick.decode_flop_parts: the
pyramid over each row's valid frames, 89 LAS steps a row, which is the
maximum: the free-running LAS always runs them, the encoder, and the beam
positions the call ran, from the kernels' launch counts, times B*K rows)
over the stretch's wall time, as a share of the H100's float32 peak
(67 TFLOP/s; the card's power limit is in the result's device entry)."""

from perfbench.yardstick import PEAK

LAYER = "the whole batch"
UNIT = "%"
MOVES = "decode_utt_per_s"


def read(r):
    f = r.extra.get("flops")
    return None if not f else 100.0 * f / (r.wall_ms / 1e3) / PEAK["f32"]
