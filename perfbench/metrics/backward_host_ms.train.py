"""Host ms a train step in the spans `stjep.train.backward`: the gradients of
each minibatch (`torch.autograd.grad`, autograd's engine included) and
their sum, over the traced steps."""

from perfbench import spans

LAYER = "autograd backward"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(r):
    ivs = spans.intervals(r, spans.TRAIN_BACKWARD)
    return spans.total_us(ivs) / 1e3 / r.units if ivs and r.units else None
