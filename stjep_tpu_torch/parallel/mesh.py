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

Training keeps its params in the layout `place_params` gives (JAX's
`shard_params` for the Trainer): a ruled leaf is held only as a `Shards`,
its n slices in shard order, slice m on the first data row's device m;
every other leaf once, on the mesh's first device. Adam runs over the
slices, so a ruled leaf's moments are slices too (JAX's
`opt_state_shardings`). `gather_params` is the inverse. The attention
projections stay replicated where the heads do not divide by n_model, as
in the TP decode (parallel/spmd.py tp_flash_ok), so a shard always holds
whole heads.

Under a process group (parallel/distributed.py) a `Mesh` is this process's
part of JAX's global one: its grid holds this process's devices, and the
data axis spans the processes, world size times the rows held here, rank r
holding the r-th run of them (`process_rows`). A model axis stays inside a
process: one that would span processes needs tensor-parallel joins between
processes, which the port does not make (`make_mesh` raises).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from stjep_tpu_torch.parallel import distributed

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
    """devices[d][m]: the device of this process's data shard d, model
    shard m; `shape` is the global mesh's, whose data axis holds n_proc
    times these rows, process `proc` holding its proc-th run of them."""

    def __init__(self, devices: Sequence[Sequence[torch.device]], n_proc: int = 1,
                 proc: int = 0):
        self.devices = [[torch.device(x) for x in row] for row in devices]
        self.n_proc, self.proc = n_proc, proc
        self.shape = {DATA_AXIS: n_proc * len(self.devices),
                      MODEL_AXIS: len(self.devices[0])}

    def process_rows(self, B: int) -> Optional[slice]:
        """This process's rows of a batch of B (`process_rows`)."""
        return process_rows(B, self.shape[DATA_AXIS], self.n_proc, self.proc)

    @property
    def lead(self) -> torch.device:
        """The first device: where replicated leaves and joins live."""
        return self.devices[0][0]


def process_rows(B: int, n_data: int, n_proc: int, proc: int) -> Optional[slice]:
    """Process `proc`'s rows of a batch of B over a global data axis of
    n_data rows held by n_proc processes: None with one process, or where B
    does not divide by n_data (then every process runs the whole batch, as
    JAX's shard_batch replicates it, stjep_tpu/parallel/mesh.py:127-129)."""
    if n_proc == 1 or B % n_data:
        return None
    b = B // n_proc
    return slice(proc * b, (proc + 1) * b)


class Shards(tuple):
    """A ruled param leaf held as its model shards' slices along its rule's
    dim (`shard_dim`), in mesh order. bridge.named_leaves walks it as a
    tuple, so each slice is a leaf of its own ("<path>/0", ...)."""


MODEL_AXIS_ACROSS_PROCESSES = (
    "a model axis that spans processes needs tensor-parallel joins between "
    "processes (NCCL across cards), which the port does not make: pick n_model "
    "dividing each process's devices")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over `devices` (every visible CUDA card by
    default), row-major as JAX reshapes them. Devices may repeat: several
    shards on one card is how tensor parallelism runs on one H100, e.g.
    make_mesh(1, 4, ["cuda"] * 4). Where the shape does not fit the
    devices, the mesh degrades to pure data parallelism with a warning, as
    the JAX function does. Under a process group `devices` are this
    process's and n_data counts the global data axis (module docstring); a
    model axis that fits the processes' devices together but not one
    process's raises ValueError, where JAX's global mesh would span them."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_mesh: no CUDA device visible; pass devices=")
    devices = [torch.device(x) for x in devices]
    n, P = len(devices), distributed.world_size()
    log = logging.getLogger(__name__)
    if P > 1 and n_model > 1 and n % n_model and (n * P) % n_model == 0:
        raise ValueError(f"make_mesh: n_model={n_model} over {P} processes of {n} "
                         f"device(s) each: {MODEL_AXIS_ACROSS_PROCESSES}")
    if n_model < 1 or n % n_model != 0:
        log.warning("make_mesh: n_model=%s does not divide %d devices; "
                    "falling back to pure data parallelism", n_model, n)
        n_data, n_model = n * P, 1
    if n_data is None:
        n_data = n // n_model * P
    if n_data * n_model != n * P:
        log.warning("make_mesh: (%d, %d) != %d devices; falling back to pure DP",
                    n_data, n_model, n * P)
        n_data, n_model = n * P, 1
    return Mesh([devices[d * n_model:(d + 1) * n_model] for d in range(n_data // P)],
                n_proc=P, proc=distributed.rank())


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


def _rule_path(path: str) -> str:
    """A bridge path ("/dec_tgt/layers/0/fc/w") in the rules' form
    ("dec_tgt.layers.0.fc.w")."""
    return path.strip("/").replace("/", ".")


def shard_dim(path: str) -> int:
    """The dim a ruled leaf at bridge path `path` is split along."""
    name = _rule_path(path)
    for rx, spec in _TP_RULES:
        if rx.match(name):
            return spec.index(MODEL_AXIS)
    raise KeyError(f"{path} has no tensor-parallel rule")


_ATTN_RULE = re.compile(r".*\b(w_qs|w_ks|w_vs|fc)\.w$")


def place_params(params: Dict, mesh: Mesh, n_head: int) -> Dict:
    """The training layout of params on the mesh (module docstring): each
    leaf `param_pspec` splits becomes a Shards of its n slices, slice m on
    mesh.devices[0][m]; every other leaf, and the attention projections
    where n_head does not divide by n, moves to the first device (itself
    where it already lies there). The slices are new leaf tensors."""
    row = mesh.devices[0]
    n = len(row)

    def place(name, leaf):
        spec = () if n_head % n and _ATTN_RULE.match(name) else param_pspec(name, leaf, n)
        if not spec:
            return leaf.detach().to(mesh.lead)
        return Shards(_shard(leaf.detach(), spec, s, n, dev) for s, dev in enumerate(row))

    return map_with_path(params, place)


def join(shards: Shards, dim: int, device) -> torch.Tensor:
    """The slices concatenated along dim on `device`, in shard order."""
    return torch.cat([t.to(device) for t in shards], dim)


def logical_leaves(tree: Any, prefix: str = "") -> list:
    """(bridge path, leaf) pairs of a params tree in bridge.named_leaves
    order, a Shards counting as one leaf: the unsharded tree's paths."""
    if isinstance(tree, Shards):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in logical_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in logical_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def gather_params(params: Dict, device=None) -> Dict:
    """The unsharded tree of a training layout (place_params' inverse):
    each Shards joined along its rule's dim on `device` (the first slice's
    device by default), every other leaf as it is; detached."""

    def walk(tree, prefix):
        if isinstance(tree, Shards):
            return join(tree, shard_dim(prefix), device or tree[0].device).detach()
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}/{i}") for i, v in enumerate(tree))
        return tree.detach()

    return walk(params, "")


def like_layout(tree: Any, layout: Any) -> Any:
    """A tree of the unsharded structure (a trainable mask, say) laid out
    as `layout`: each value repeated over the slices where layout holds a
    Shards, so that bridge.leaves of both line up."""
    if isinstance(layout, Shards):
        return Shards(tree for _ in layout)
    if isinstance(layout, dict):
        return {k: like_layout(tree[k], v) for k, v in layout.items()}
    if isinstance(layout, (list, tuple)):
        return type(layout)(like_layout(t, v) for t, v in zip(tree, layout, strict=True))
    return tree

