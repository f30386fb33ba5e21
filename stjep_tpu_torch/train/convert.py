"""Reference PyTorch checkpoint -> the port's params tree (port of
stjep_tpu/train/convert.py).

Maps the reference model's named parameters (ref: models/Seq2seq.py's
module tree; torch.nn.LSTM layouts with the (i, f, g, o) gate order) onto
the port's tree, which has the JAX package's key paths and `[in, out]`
layouts, as torch tensors on the host. The values are the reference's
bits, moved, never recomputed.

Layout rules:
- Linear weight [out, in] -> 'w' [in, out] (transposed); bias -> 'b'
- LSTM weight_ih_l0 [4H, D] -> 'w_ih' [D, 4H] (transposed); the gate order
  (i, f, g, o) is shared, so no reordering
- '_reverse' LSTM params -> the 'bwd' direction of a bilstm
- LayerNorm weight/bias -> scale/bias
- Embedding weight -> the table itself
- the reference's 'dec.l{i}' residual stack -> 'dec_l{i}'
- 'enc_layers.{i}' / 'dec_layers.{i}' (standard: deep clones) ->
  'layers'[i]; the universal type's shared template module 'enc'/'dec' ->
  'layers'[0]; the unused template params of the standard type are
  dropped. ACT's halting unit 'act_fn.p' keeps its path.
- share_embedder: the table torch registers under one name also fills the
  other (as a copy); emb_dyn_ave from the artifact, else zeros.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from stjep_tpu_torch.config import ModelConfig

_LSTM_LEAVES = {
    "weight_ih_l0": ("w_ih", True),
    "weight_hh_l0": ("w_hh", True),
    "bias_ih_l0": ("b_ih", False),
    "bias_hh_l0": ("b_hh", False),
}


def _tensor(arr: np.ndarray, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(arr)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a).copy())


def _set_path(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _las_decoder_path(mod_path):
    """The residual decoder stack's 'dec', 'l{i}' -> 'dec_l{i}'."""
    path, i = [], 0
    while i < len(mod_path):
        if (mod_path[i] == "dec" and i + 1 < len(mod_path)
                and re.match(r"l\d+$", mod_path[i + 1])):
            path.append("dec_" + mod_path[i + 1])
            i += 2
        else:
            path.append(mod_path[i])
            i += 1
    return path


def convert_named_params(named: Dict[str, np.ndarray], cfg: ModelConfig,
                         emb_dyn_ave: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """{reference parameter name: numpy array} -> the port's params tree.

    `named` uses the reference Seq2seq naming (e.g. `{n: p.detach().numpy()
    for n, p in model.named_parameters()}`); names starting with 'encoder.'
    or 'decoder.' (a bare LAS checkpoint) get an implicit 'las.' prefix."""
    tree: Dict[str, Any] = {}
    layer_store: Dict[str, Dict[int, Dict]] = {"enc_src": {}, "dec_tgt": {}}

    for name, arr in named.items():
        if name.startswith(("encoder.", "decoder.")):
            name = "las." + name
        parts = name.split(".")
        # the standard type's unused template modules (ref: TFEnc.py:51,58)
        if (cfg.transformer_type == "standard" and parts[0] in layer_store
                and parts[1] in ("enc", "dec")):
            continue
        leaf, mod_path = parts[-1], parts[:-1]

        m = re.match(r"(weight|bias)_(ih|hh)_l0(_reverse)?$", leaf)
        if m:  # LSTM params
            new_leaf, transpose = _LSTM_LEAVES[f"{m.group(1)}_{m.group(2)}_l0"]
            reverse = m.group(3) is not None
            if any(p.startswith("acous_enc_l") for p in mod_path):
                # pyramid bilstm: las.encoder.acous_enc_l{k}
                path = mod_path + ["bwd" if reverse else "fwd", new_leaf]
            else:
                if reverse:
                    raise ValueError(f"a reverse LSTM outside the pyramid: {name}")
                path = _las_decoder_path(mod_path) + [new_leaf]
            _set_path(tree, path, _tensor(arr, transpose))
            continue

        parent = mod_path[-1] if mod_path else ""
        if parent.endswith("embedder"):  # nn.Embedding weight -> the table
            if leaf != "weight":
                raise ValueError(f"unrecognized param {name}")
            _set_path(tree, mod_path, _tensor(arr))
            continue
        if parent in ("layer_norm", "norm"):
            new_leaf, val = ("scale" if leaf == "weight" else "bias"), _tensor(arr)
        elif leaf == "weight":
            new_leaf, val = "w", _tensor(arr, True)
        elif leaf == "bias":
            new_leaf, val = "b", _tensor(arr)
        else:
            raise ValueError(f"unrecognized param {name}")

        path = mod_path + [new_leaf]
        if len(path) >= 3 and path[0] in layer_store:
            store = layer_store[path[0]]
            if path[1] in ("enc_layers", "dec_layers"):
                _set_path(store.setdefault(int(path[2]), {}), path[3:], val)
                continue
            if path[1] in ("enc", "dec") and cfg.transformer_type == "universal":
                _set_path(store.setdefault(0, {}), path[2:], val)
                continue
        _set_path(tree, path, val)

    for owner, store in layer_store.items():
        if store:
            tree.setdefault(owner, {})["layers"] = [store[i] for i in sorted(store)]

    if cfg.share_embedder:  # torch names a shared module once, by its first name
        if "dec_embedder" not in tree and "enc_embedder" in tree:
            tree["dec_embedder"] = tree["enc_embedder"].clone()
        if "enc_embedder" not in tree and "dec_embedder" in tree:
            tree["enc_embedder"] = tree["dec_embedder"].clone()

    if emb_dyn_ave is not None:
        tree["emb_dyn_ave"] = _tensor(np.asarray(emb_dyn_ave).reshape(-1))
    elif "emb_dyn_ave" not in tree:
        tree["emb_dyn_ave"] = torch.zeros((cfg.dim_model,), dtype=torch.float32)
    return tree


def convert_torch_model(model, cfg: ModelConfig) -> Dict[str, Any]:
    """Convert a live reference model, or an unpickled reference checkpoint
    module: its named_parameters and its EMB_DYN_AVE buffer, if it has one."""
    named = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
    emb_dyn = None
    if hasattr(model, "EMB_DYN_AVE"):
        emb_dyn = np.asarray(model.EMB_DYN_AVE.detach().cpu().numpy()).reshape(-1)
    return convert_named_params(named, cfg, emb_dyn_ave=emb_dyn)
