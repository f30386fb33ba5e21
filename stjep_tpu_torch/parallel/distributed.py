"""Process-group bootstrap and the few collectives training needs (port of
stjep_tpu/parallel/distributed.py, on torch.distributed).

JAX's multi-host SPMD needs `jax.distributed.initialize()`, a global mesh,
each host feeding its shard of the global batch, and process-0-only
checkpoint writes; XLA emits the collectives. The port does the same by
hand: `init_distributed` joins the process group, parallel/mesh.py's
`make_mesh` spans the data axis over the processes, the Trainer cuts each
batch to the process's rows (train/trainer.py), the gradients are summed
in one `all_reduce_sum` of a flat bucket (the counterpart of the psum XLA
emits), and train/checkpoint.py writes from rank 0 behind a `barrier`.

Backends: `nccl` where the ranks train on CUDA with a card each; `gloo`
where ranks share a card (NCCL refuses two ranks on one device) or train on
the CPU. gloo's all_reduce takes the CUDA bucket as it is; only a host
tensor under nccl (a checkpoint's clock, dev eval's numbers) is staged
through the card.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

# torchrun's counterparts of JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
ENV_KEYS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def local_world(world: int, local_world_size: Optional[int] = None) -> int:
    """The ranks on this host: `local_world_size`, else torchrun's
    LOCAL_WORLD_SIZE, else all `world` of them (one host)."""
    return int(local_world_size or os.environ.get("LOCAL_WORLD_SIZE") or world)


def choose_backend(device, local: int) -> str:
    """nccl when the ranks train on CUDA and each of this host's `local`
    ranks has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 1800.0,
                     device="cuda",
                     local_world_size: Optional[int] = None) -> None:
    """Join the process group. With no arguments and none of ENV_KEYS in
    the environment: a no-op (one process, as JAX's is). With those
    variables set: through `env://` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). With arguments: through `tcp://<coordinator_address>`, or the
    address itself where it is a URL (`file://...` avoids port races). A
    failed rendezvous raises: a job asked to run on several processes never
    degrades to independent single-process ones with diverging checkpoints
    (JAX :33-41). `backend` None picks nccl or gloo from the `device` the
    ranks train on and the ranks on this host (`local_world`; pass
    `local_world_size` where several hosts join through explicit
    arguments)."""
    if coordinator_address is None and num_processes is None:
        if not any(os.environ.get(k) for k in ENV_KEYS):
            return
        url = "env://"
        world = int(os.environ.get("WORLD_SIZE") or 1)
        kw = {}
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("init_distributed: pass coordinator_address, num_processes "
                             "and process_id together")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world = int(num_processes)
        kw = {"world_size": world, "rank": int(process_id)}
    local = local_world(world, local_world_size)
    backend = backend or choose_backend(device, local)
    if backend == "nccl":
        r = kw.get("rank", int(os.environ.get("RANK") or 0))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK") or r % local))
    dist.init_process_group(backend, init_method=url,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    logging.getLogger(__name__).info(
        "process group: rank %d of %d, backend %s (%s)", rank(), world_size(), backend,
        "a card a rank" if backend == "nccl" else "ranks share a card or run on the CPU")


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return rank() == 0


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point (no-op with one process). Used after
    checkpoint writes so no rank reads a half-written dir."""
    if world_size() > 1:
        logging.getLogger(__name__).debug("barrier %s", name)
        dist.barrier()


def local_batch_slice(global_batch: int) -> slice:
    """The row range of the global batch this process feeds. The global
    batch must divide evenly: silently dropping remainder rows would lose
    data on every step."""
    n = world_size()
    assert global_batch % n == 0, (
        f"global batch {global_batch} must be a multiple of "
        f"process_count {n} (pick batch_size = k * {n})")
    per_host = global_batch // n
    start = rank() * per_host
    return slice(start, start + per_host)


def all_reduce_sum(flat: torch.Tensor) -> torch.Tensor:
    """Sum a 1-D tensor over the processes, in place, and return it (itself
    with one process). Every rank gets the same bytes. gloo takes host and
    CUDA tensors alike; nccl reduces a host tensor through a copy on the
    current card."""
    if flat.dim() != 1:
        raise ValueError(f"all_reduce_sum takes a flat bucket, got shape {tuple(flat.shape)}")
    if world_size() == 1:
        return flat
    if dist.get_backend() == "nccl" and not flat.is_cuda:
        buf = flat.to("cuda")
        dist.all_reduce(buf)
        flat.copy_(buf)
    else:
        dist.all_reduce(flat)
    return flat
