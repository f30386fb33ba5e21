"""Host ms a train step in the spans `stjep.train.forward`: the forward and
the head losses of each minibatch (`forward_train`, `head_losses`), over
the traced steps."""

from perfbench import spans

LAYER = "train forward"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(r):
    ivs = spans.intervals(r, spans.TRAIN_FORWARD)
    return spans.total_us(ivs) / 1e3 / r.units if ivs and r.units else None
