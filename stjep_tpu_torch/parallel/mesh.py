"""A (data, model) device mesh and the tensor-parallel split of the
transformer weights (port of the TP parts of stjep_tpu/parallel/mesh.py).

The port drives every shard from one process: a `Mesh` is a grid
[n_data][n_model] of torch devices, and a device may repeat, so that 2- or
4-way tensor parallelism runs with every shard on one card (the shards'
kernels run in turn on it). `shard_params` cuts the params Megatron-style
by `_TP_RULES`, the JAX package's rules on the same key paths: the Q/K/V
projections and FFN w_1 (and its bias) by column, over the heads and the
hidden dim; the attention output projection `fc` and FFN w_2 by row; the
vocabulary projection out_tgt by column. A leaf is split only where every
split dim divides by n_model; everything else is replicated.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

# param-path regex -> the axis each dim is split over (None: not split).
# Matched in order; first hit wins (JAX parallel/mesh.py:68-78).
_TP_RULES = [
    # attention projections: column-parallel QKV, row-parallel output
    (re.compile(r".*\b(w_qs|w_ks|w_vs)\.w$"), (None, MODEL_AXIS)),
    (re.compile(r".*\bfc\.w$"), (MODEL_AXIS, None)),
    # FFN: column-parallel w_1, row-parallel w_2
    (re.compile(r".*pos_ffn\.w_1\.w$"), (None, MODEL_AXIS)),
    (re.compile(r".*pos_ffn\.w_1\.b$"), (MODEL_AXIS,)),
    (re.compile(r".*pos_ffn\.w_2\.w$"), (MODEL_AXIS, None)),
    # vocab projection: column-parallel over the vocabulary
    (re.compile(r"^out_tgt\.w$"), (None, MODEL_AXIS)),
]


class Mesh:
    """devices[d][m]: the device of data shard d, model shard m."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(x) for x in row] for row in devices]
        self.shape = {DATA_AXIS: len(self.devices),
                      MODEL_AXIS: len(self.devices[0])}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over `devices` (every visible CUDA card by
    default), row-major as JAX reshapes them. Devices may repeat: several
    shards on one card is how tensor parallelism runs on one H100, e.g.
    make_mesh(1, 4, ["cuda"] * 4). Where the shape does not fit the
    devices, the mesh degrades to pure data parallelism with a warning, as
    the JAX function does."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_mesh: no CUDA device visible; pass devices=")
    devices = [torch.device(x) for x in devices]
    n = len(devices)
    log = logging.getLogger(__name__)
    if n_model < 1 or n % n_model != 0:
        log.warning("make_mesh: n_model=%s does not divide %d devices; "
                    "falling back to pure data parallelism", n_model, n)
        n_data, n_model = n, 1
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        log.warning("make_mesh: (%d, %d) != %d devices; falling back to pure DP",
                    n_data, n_model, n)
        n_data, n_model = n, 1
    return Mesh([devices[d * n_model:(d + 1) * n_model] for d in range(n_data)])


def map_with_path(tree: Any, fn: Callable[[str, Any], Any], prefix: Tuple = ()):
    """Rebuild the tree applying fn(path, leaf) at every leaf, the path
    joined with "." (JAX train/policies.py map_with_path)."""
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(".".join(prefix), tree)


def param_pspec(name: str, leaf, n_model: int) -> Tuple:
    """The split of one parameter path: per dim MODEL_AXIS or None, () when
    replicated. Only when every split dim divides by n_model."""
    if n_model > 1:
        for rx, spec in _TP_RULES:
            if rx.match(name):
                if all(ax != MODEL_AXIS or d % n_model == 0
                       for d, ax in zip(leaf.shape, spec)):
                    return spec
    return ()


def _shard(leaf: torch.Tensor, spec: Tuple, s: int, n: int, dev) -> torch.Tensor:
    """Shard s of n of leaf along its MODEL_AXIS dim, contiguous on dev
    (a column slice is strided, and the kernels take contiguous weights)."""
    for dim, ax in enumerate(spec):
        if ax == MODEL_AXIS:
            w = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, s * w, w)
    return leaf.to(dev).contiguous()


def shard_params(params: Dict, mesh: Mesh, data_index: int = 0) -> List[Dict]:
    """One params tree per model shard of data row `data_index`, each on
    its shard's device: the TP-ruled leaves cut (shard m holds JAX's
    param_pspec slice m), the others moved (shared where already there).
    Build once per call, outside the decode loop."""
    row = mesh.devices[data_index]
    n = len(row)
    return [map_with_path(params, lambda name, leaf, s=s, dev=dev: _shard(
                leaf, param_pspec(name, leaf, n), s, n, dev))
            for s, dev in enumerate(row)]
