"""Host ms a train step in the spans `stjep.train.optimizer`:
`Optimizer.update`: the trainable leaves' selection, the global-norm clip
and Adam's step, over the traced steps."""

from perfbench import spans

LAYER = "optimizer"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(r):
    ivs = spans.intervals(r, spans.TRAIN_OPTIMIZER)
    return spans.total_us(ivs) / 1e3 / r.units if ivs and r.units else None
