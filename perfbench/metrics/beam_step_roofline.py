"""The fused beam step's share of its roofline: the least time of the work
of every traced megastep (yardstick.megastep_bound, from each call's
position, the distinct cache rows its ancestry reads and the valid memory
rows) over the device time of the kernels that work/beam_step*.json name."""

LAYER = "fused decode"
UNIT = "%"
MOVES = "decode_utt_per_s"
WORK = "beam_step"


def read(r):
    return r.roofline(WORK)
