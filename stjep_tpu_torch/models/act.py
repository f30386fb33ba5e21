"""Adaptive Computation Time for the universal transformer (port of
stjep_tpu/models/act.py).

The halting loop (ref: models/Act.py:10-172) is a plain Python `while` on
the JAX loop's condition, read on the host once a hop; its body is JAX's
expression for expression, in the same order, so it keeps two of its
properties:

- `halting_p + remainders` can round just below 1.0, and such a halted
  position counts as running again in a later hop (`halting_p < 1.0`),
  where it takes its remainder as update weight once more. The loop runs
  while any position of the whole batch still runs, so a position's result
  can depend on the other rows and on the PAD positions of its buffer:
  callers that hold the port to JAX run the same batch over the same
  buffer.
- The time signal and the layer signal are added to the state every hop,
  inside the loop.

JAX reads the layer signal with `jnp.take(layer_sig, step, axis=1)`, which
fills NaN past the last layer when `act_max_hop` exceeds the layer count
(the reference indexes out of range); the port raises ValueError then.
The shared layer runs deterministic (no dropout): ACT has no training
route (ACT_NO_GRAD). Plain PyTorch: the JAX package runs this loop in
XLA, with no kernel of its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from stjep_tpu_torch.ops.attention import linear, linear_init
from stjep_tpu_torch.ops.transformer import decoder_layer, encoder_layer

ACT_THRESHOLD = 1.0 - 0.1  # ref: Act.py:18

ACT_NO_GRAD = (
    "ACT models do not train: the halting loop is a while loop with a "
    "data-dependent hop count, and JAX's reverse-mode differentiation does "
    "not work for lax.while_loop (stjep_tpu/models/act.py), so the JAX "
    "package's first ACT train step raises; the port follows it and decodes "
    "and evaluates ACT models only (e.g. a reference checkpoint converted by "
    "stjep_tpu_torch/scripts/convert_torch_checkpoint.py)")


def act_init(generator: torch.Generator, hidden_size: int, device=None,
             dtype=torch.float32) -> Dict:
    """The halting unit p: Linear(hidden_size, 1), bias 1 (ref: Act.py:17)."""
    p = linear_init(generator, hidden_size, 1, bias=True, device=device, dtype=dtype)
    p["b"] = torch.ones_like(p["b"])
    return {"p": p}


def _act_loop(act_params: Dict, transform, state: torch.Tensor,
              time_sig: torch.Tensor, layer_sig: torch.Tensor,
              max_hop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """state [B, L, D], time_sig [1, >=L, D], layer_sig [1, layers, D];
    transform: the shared layer, state -> new state. Returns (the weighted
    state [B, L, D], layer map [B, L]). ValueError where JAX's layer-signal
    read would go out of range (module docstring)."""
    if max_hop > layer_sig.shape[1]:
        raise ValueError(
            f"act_max_hop {max_hop} exceeds the {layer_sig.shape[1]} layers: the "
            "layer signal has one row a layer (JAX reads NaN past it, the "
            "reference indexes out of range)")
    B, L, _ = state.shape
    zeros = state.new_zeros((B, L))
    prev_state = torch.zeros_like(state)
    halting_p, remainders, n_updates, layer_map = zeros, zeros, zeros, zeros
    tsig = time_sig[:, :L, :].to(state.dtype)
    step = 0
    while bool(((halting_p < ACT_THRESHOLD) & (n_updates < max_hop)).any()):
        state = state + tsig
        state = state + layer_sig[:, step, :][:, None, :].expand(state.shape).to(state.dtype)

        p = torch.sigmoid(linear(act_params["p"], state))[..., 0]  # [B, L]
        still_running = (halting_p < 1.0).to(state.dtype)
        new_halted = (
            (halting_p + p * still_running) > ACT_THRESHOLD
        ).to(state.dtype) * still_running
        still_running = (
            (halting_p + p * still_running) <= ACT_THRESHOLD
        ).to(state.dtype) * still_running
        halting_p = halting_p + p * still_running
        remainders = remainders + new_halted * (1 - halting_p)
        halting_p = halting_p + new_halted * remainders
        n_updates = n_updates + still_running + new_halted
        update_weights = p * still_running + remainders * new_halted

        state = transform(state)
        prev_state = (
            state * update_weights[..., None]
            + prev_state * (1 - update_weights[..., None])
        )
        step = step + 1
        layer_map = layer_map + new_halted * step
    # positions that never halted are assigned max_hop (ref: Act.py:95)
    still_running = (halting_p < 1.0).to(state.dtype)
    layer_map = layer_map + still_running * max_hop
    return prev_state, layer_map


def act_enc_apply(act_params: Dict, layer_params: Dict, cfg, state: torch.Tensor,
                  src_mask, time_sig: torch.Tensor, layer_sig: torch.Tensor,
                  max_hop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's halting loop over its shared layer (ref: Act.py:21-97)."""

    def transform(x):
        return encoder_layer(layer_params, x, cfg.num_heads, mask=src_mask)

    return _act_loop(act_params, transform, state, time_sig, layer_sig, max_hop)


def act_dec_apply(act_params: Dict, layer_params: Dict, cfg, state: torch.Tensor,
                  memory: torch.Tensor, tgt_mask, src_mask, time_sig: torch.Tensor,
                  layer_sig: torch.Tensor, max_hop: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's halting loop over its shared layer (ref: Act.py:100-172)."""

    def transform(x):
        return decoder_layer(layer_params, x, memory, cfg.num_heads,
                             self_mask=tgt_mask, cross_mask=src_mask)

    return _act_loop(act_params, transform, state, time_sig, layer_sig, max_hop)
