"""The decoder layer step's share of its roofline: the least time of the
work of every traced layer step (yardstick.decode_bound for one layer)
over the device time of the kernels that work/layer_step*.json name."""

LAYER = "decoder layer step"
UNIT = "%"
MOVES = "decode_utt_per_s"
WORK = "layer_step"


def read(r):
    return r.roofline(WORK)
