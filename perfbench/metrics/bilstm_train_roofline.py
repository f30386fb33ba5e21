"""The trainable pyramid's share of its roofline: the least time of its K8
work in the traced steps (yardstick.bilstm_train_work: the forward's
products, the backward sweep's recurrent product, each layer's input,
weights and cotangent read and its output and dPre written once) over the
device time of the kernels that work/bilstm_train*.json name."""

LAYER = "LAS encoder"
UNIT = "%"
MOVES = "train_samples_per_s"
WORK = "bilstm_train"


def read(r):
    return r.roofline(WORK)
