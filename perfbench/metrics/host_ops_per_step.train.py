"""Host aten:: operators a train step, over the traced steps."""

LAYER = "train entry"
UNIT = "ops"
MOVES = "train_samples_per_s"


def read(r):
    return r.host_ops / r.units if r.units else None
