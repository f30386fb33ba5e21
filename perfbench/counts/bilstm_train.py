"""The work of the trainable pyramid (K8) in the traced training steps,
from the pool's frame lengths (yardstick.bilstm_train_work); None in a
cell whose steps run no pyramid."""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def stretch(run, st: Dict, n: int) -> Optional[Tuple[int, int]]:
    b = st["pool"][0]
    if "acous_feat" not in b:
        return None
    y, model = run.yardstick, run.model
    nb, fl = y.bilstm_train_work(b["acouslen"].tolist(), b["acous_feat"].shape[1],
                                 model["acous_dim"], model["acous_hidden_size"],
                                 model["num_pyramid_layers"])
    return n * nb, n * fl
