"""Mesh dispatch of the decode kernels (port of the decode parts of
stjep_tpu/parallel/spmd.py).

The active mesh is process-global state (`set_kernel_mesh`), as in the JAX
package; `beam_search` and `forward_eval` read it. With no mesh they run
the single-device kernel routes. Under a mesh each data shard decodes its
slice of the batch on its own devices, with its own loop and its own
all-EOS exit (JAX :214-216), one shard after the other in this process:

- a pure data-parallel mesh (n_model == 1): the single-device route per
  slice, on the replicated params;
- a mesh with a model axis where `tp_flash_ok`: the tensor-parallel route
  per slice, over the slice's model axis (ops/decode_flash_tp.py), on the
  params cut by parallel/mesh.py shard_params once per call;
- a mesh with a model axis where the split dims do not all divide: JAX
  takes its dense, sharding-aware XLA decode there. The port has no dense
  decode, so it runs its single-device kernel route on the full params,
  which computes the same function (JAX pins the equality in
  tests/test_tp_decode.py test_tp_flash_gate_requires_divisible_dims).

A batch that does not divide by n_data takes the unsharded call (JAX
:248-250, :315-318). int8 weights under a model axis raise (JAX :277-284).
The encoder has no mesh wrapper yet: it runs the whole batch where the
call runs (its kernels are batch-parallel, so the values are the same).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stjep_tpu_torch.bridge import params_to
from stjep_tpu_torch.ops.decode_flash_tp import ModelAxis
from stjep_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_params

_KERNEL_MESH: Optional[Mesh] = None


def set_kernel_mesh(mesh: Optional[Mesh]):
    """Install (or clear) the mesh the decode kernels shard over."""
    global _KERNEL_MESH
    _KERNEL_MESH = mesh


def kernel_mesh() -> Optional[Mesh]:
    return _KERNEL_MESH


def dp_only_mesh() -> bool:
    """True when a mesh is installed and has no model axis (n_model == 1)."""
    mesh = kernel_mesh()
    return mesh is not None and mesh.shape[MODEL_AXIS] == 1


def tp_flash_ok(cfg) -> bool:
    """Whether the tensor-parallel decode can run under the active mesh for
    this config: a model axis, and every Megatron-split dim (heads,
    dim_model, dim_feedforward, dec_vocab_size) divisible by it, so that
    shard_params really split those weights (JAX :65-84, without its
    128-lane clause, a TPU layout limit)."""
    mesh = kernel_mesh()
    if mesh is None:
        return False
    n = mesh.shape[MODEL_AXIS]
    return n > 1 and not (cfg.num_heads % n or cfg.dim_model % n
                          or cfg.dim_feedforward % n or cfg.dec_vocab_size % n)


def _per_data_shard(decode, params, cfg, batched: Dict[str, Optional[torch.Tensor]],
                    **kw):
    """decode(params, cfg, **batched, **kw) under the kernel mesh (module
    docstring). Unsharded where no mesh is installed, where a model axis
    cannot split this config, or where the batch does not divide by n_data;
    else once per data shard on its batch slice (the first `batched` tensor
    sets the batch; None stays None), on its row's first device, with the
    params replicated there (DP) or its row's shard_params and model axis
    (TP; decode's `tp=`), each built once per distinct device row. The
    shards' results concatenated on the batch axis."""
    mesh = kernel_mesh()
    lead = next(iter(batched.values()))
    tp = mesh is not None and not dp_only_mesh()
    if mesh is None or (tp and not tp_flash_ok(cfg)) or lead.shape[0] % mesh.shape[DATA_AXIS]:
        return decode(params, cfg, **batched, **kw)
    n = mesh.shape[DATA_AXIS]
    b = lead.shape[0] // n
    built, outs = {}, []
    for d in range(n):
        row = tuple(mesh.devices[d])
        if row not in built:
            built[row] = shard_params(params, mesh, d) if tp else params_to(params, row[0])
        part = {k: None if t is None else t[d * b:(d + 1) * b].to(row[0])
                for k, t in batched.items()}
        outs.append(decode(built[row], cfg, **part, **kw,
                           **({"tp": ModelAxis(row)} if tp else {})))
    return tuple(torch.cat([o[i].to(lead.device) for o in outs]) for i in range(len(outs[0])))


def greedy_decode_flash_dp(params, cfg, enc_outputs, mem_mask_b, length_out: int,
                           max_time: int, ref_tokens):
    """models/seq2seq.py _greedy_decode_flash under the kernel mesh (module
    docstring): per data shard, and tensor-parallel where the mesh has a
    model axis. Same arguments and results."""
    from stjep_tpu_torch.models.seq2seq import _greedy_decode_flash

    return _per_data_shard(_greedy_decode_flash, params, cfg,
                           dict(enc_outputs=enc_outputs, mem_mask_b=mem_mask_b,
                                ref_tokens=ref_tokens),
                           length_out=length_out, max_time=max_time)


def beam_search_flash_dp(params, cfg, enc_outputs, mem_mask_b, beam_width: int,
                         penalty_factor: float, max_seq_len: int, cache_dtype=None,
                         weight_dtype=None):
    """infer/beam.py's beam under the kernel mesh (module docstring): per
    data shard, and tensor-parallel where the mesh has a model axis, which
    keeps f32 weights: weight_dtype='int8' raises there. bf16 caches are
    allowed under either."""
    from stjep_tpu_torch.infer.beam import _beam_search_flash

    mesh = kernel_mesh()
    if mesh is not None and mesh.shape[MODEL_AXIS] > 1 and weight_dtype is not None:
        raise ValueError(
            f"weight_dtype={weight_dtype!r} is not supported under a "
            "tensor-parallel mesh (the TP decode trio has no dequant path); "
            "drop the weight dtype or use a pure data-parallel mesh")
    return _per_data_shard(_beam_search_flash, params, cfg,
                           dict(enc_outputs=enc_outputs, mem_mask_b=mem_mask_b),
                           beam_width=beam_width, penalty_factor=penalty_factor,
                           max_seq_len=max_seq_len, cache_dtype=cache_dtype,
                           weight_dtype=weight_dtype)
