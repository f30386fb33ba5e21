"""Mesh dispatch of the kernels (port of stjep_tpu/parallel/spmd.py).

The active mesh is process-global state (`set_kernel_mesh`), as in the JAX
package; the Trainer installs its (data, model) mesh there, and the LAS
modules, `beam_search` and `forward_eval` read it. With no mesh everything
runs the single-device kernel routes.

The LAS kernels are batch-parallel with replicated weights: `bilstm_dp`
(K1, or K8 under autograd), `las_tf_scan_dp` (K9) and
`las_greedy_flash_dp` (K2) run the kernel once per data shard, on its
batch slice, on that data row's first device, and join the results on the
batch axis where the call runs, as JAX's shard_map over 'data' does. The
weights reach each shard through autograd-tracked copies (nothing moves
when the rows share a card), so autograd sums their gradients over the
shards, as shard_map's transpose psums them. With no mesh, one data row,
or a batch that does not divide by n_data, each makes the plain call.

The transformer decode runs per data shard as well, each shard with its
own loop and its own all-EOS exit (JAX :214-216), one after the other in
this process:

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
An ACT decoder, as in JAX's `decode_flash_auto` (:87-107), takes the dense
decode under any mesh: it re-runs its token buffer on the whole batch where
the call runs, never per data shard, since the halting loop runs while any
position of the batch runs (a shard's batch would change its tokens). The
dense greedy of `forward_eval` without reference ids likewise runs the
whole batch where the call runs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from stjep_tpu_torch.bridge import params_to
from stjep_tpu_torch.ops.decode_flash_tp import ModelAxis
from stjep_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, shard_params

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


def _data_rows(B: int) -> Optional[List[torch.device]]:
    """The data rows' first devices when a batch of B shards over the
    installed mesh's data axis, else None (no mesh, one row, or B not
    divisible by n_data): then the plain call runs. Under a process group
    the rows are this process's and B its batch (its rows of the whole)."""
    mesh = kernel_mesh()
    if mesh is None:
        return None
    n = len(mesh.devices)
    if n == 1 or B % n:
        return None
    return [row[0] for row in mesh.devices]


def _cut(t: Optional[torch.Tensor], axis: int, d: int, n: int, dev):
    """Data shard d of n of t along axis, on dev (None stays None)."""
    if t is None:
        return None
    b = t.shape[axis] // n
    return t.narrow(axis, d * b, b).to(dev)


def _joined(outs: List[torch.Tensor], axis: int, device) -> torch.Tensor:
    return torch.cat([o.to(device) for o in outs], axis)


def _current(dev: torch.device):
    """dev as the current card while a shard's kernel launches there (the
    kernels launch on the current card); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def bilstm_dp(kernel_fn, params_fwd: Dict, params_bwd: Dict, x: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """kernel_fn(pf, pb, x [B, T, D], lengths [B]) -> [B, T, 2H] (K1's
    bilstm_pallas, or K8's bilstm_pallas_trainable under autograd) per data
    shard (module docstring), joined on B (JAX :143-152)."""
    rows = _data_rows(x.shape[0])
    if rows is None:
        return kernel_fn(params_fwd, params_bwd, x, lengths)
    n = len(rows)
    outs = []
    for d, dev in enumerate(rows):
        with _current(dev):
            outs.append(kernel_fn(params_to(params_fwd, dev), params_to(params_bwd, dev),
                                  _cut(x, 0, d, n, dev), _cut(lengths, 0, d, n, dev)))
    return _joined(outs, 0, x.device)


def las_tf_scan_dp(stack: Dict, att_w: torch.Tensor, ffn_w: torch.Tensor,
                   pre0_steps: torch.Tensor, acous_outputs: torch.Tensor,
                   lens_k: torch.Tensor, masks) -> torch.Tensor:
    """K9's teacher-forced scan (ops/las_tf_flash.py las_tf_scan) per data
    shard (module docstring): pre0_steps [S, B, 4Hd] (batch axis 1),
    acous_outputs [B, Tk, Ha2], lens_k [B], masks (lstm [S, n, B, Hd], ctx
    [S, B, 1, Ha2]) or None, drawn for the whole batch and cut here; out
    [S, B, Hs] (JAX :158-178)."""
    from stjep_tpu_torch.ops.las_tf_flash import las_tf_scan

    rows = _data_rows(acous_outputs.shape[0])
    if rows is None:
        return las_tf_scan(stack, att_w, ffn_w, pre0_steps, acous_outputs, lens_k, masks)
    n = len(rows)
    outs = []
    for d, dev in enumerate(rows):
        m = None if masks is None else (_cut(masks[0], 2, d, n, dev),
                                        _cut(masks[1], 1, d, n, dev))
        with _current(dev):
            outs.append(las_tf_scan(params_to(stack, dev), att_w.to(dev), ffn_w.to(dev),
                                    _cut(pre0_steps, 1, d, n, dev),
                                    _cut(acous_outputs, 0, d, n, dev),
                                    _cut(lens_k, 0, d, n, dev), m))
    return _joined(outs, 1, acous_outputs.device)


def las_greedy_flash_dp(params: Dict, cfg, wk: torch.Tensor, att_values: torch.Tensor,
                        lens_k: torch.Tensor, sym0: torch.Tensor, n_steps: int,
                        ref_tokens: Optional[torch.Tensor] = None):
    """K2's free-running decode (ops/las_flash.py las_greedy_flash) per
    data shard (module docstring). Returns (embs [B, S, Hs], preds [B, S],
    picked [B, S]) (JAX :182-203)."""
    from stjep_tpu_torch.ops.las_flash import las_greedy_flash

    rows = _data_rows(wk.shape[0])
    if rows is None:
        return las_greedy_flash(params, cfg, wk, att_values, lens_k, sym0, n_steps,
                                ref_tokens=ref_tokens)
    n = len(rows)
    outs = []
    for d, dev in enumerate(rows):
        with _current(dev):
            outs.append(las_greedy_flash(params_to(params, dev), cfg, _cut(wk, 0, d, n, dev),
                                         _cut(att_values, 0, d, n, dev),
                                         _cut(lens_k, 0, d, n, dev), _cut(sym0, 0, d, n, dev),
                                         n_steps, ref_tokens=_cut(ref_tokens, 0, d, n, dev)))
    return tuple(_joined([o[i] for o in outs], 0, wk.device) for i in range(3))


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
    if mesh is None or (tp and not tp_flash_ok(cfg)) or lead.shape[0] % len(mesh.devices):
        return decode(params, cfg, **batched, **kw)
    n = len(mesh.devices)
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
