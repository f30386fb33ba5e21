"""Weight bridge between the JAX package's params and the port's tensors.

Both sides use the same key paths (`las/encoder/acous_enc_l1/fwd/w_ih`,
`dec_tgt/layers/<i>/decslf_attn/w_qs/w`, ...) and the same `[in, out]`
layout, so the bridge is a copy: nested dicts (and lists) of numpy arrays
become the same structure of torch tensors, and back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts/lists/tuples of array-likes -> the same structure of
    torch tensors on `device` (dtypes and bytes unchanged)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of params_from_numpy: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def named_leaves(tree: Any, prefix: str = "") -> list:
    """(path, leaf) pairs of a params tree, depth first in key order, with
    paths like "/las/encoder/acous_enc_l1/fwd/w_ih"."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in named_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    """The leaves of a params tree, in named_leaves order."""
    return [t for _, t in named_leaves(tree)]


def params_to(tree: Any, device) -> Any:
    """Move every tensor of a params tree to `device`."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to(v, device) for v in tree)
    return tree.to(device)


def check_params_device(params: Any, device) -> torch.device:
    """The device an entry point runs on, torch.device(device); raises
    ValueError, naming both devices, when a leaf of params lies elsewhere
    (the entry points never move params themselves)."""
    dev = torch.device(device)
    for name, t in named_leaves(params):
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(
                f"params leaf {name} is on {t.device} but the call runs on "
                f"{dev}: move the params with bridge.params_to(params, "
                f"{str(dev)!r}), or pass device={str(t.device)!r}")
    return dev
