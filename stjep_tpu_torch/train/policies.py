"""Parameter-tree path utilities + the reference's load/freeze policies
(port of stjep_tpu/train/policies.py on the port's nested dict of tensors;
tests/test_torch_trainer.py holds the params and masks of every load mode
equal to the JAX module's).

The reference implements staged pretraining via name-matched parameter
copying and requires_grad freezing (ref: trainer/trainer_base.py:185-414).
Here params are nested dict/list pytrees, so a policy is just a predicate on
the dotted path string:

  load_mode  copy                          freeze (iff load_freeze)
  ---------  ----------------------------  --------------------------------
  LAS        las.encoder.*                 las.encoder.*
  ASR        las.* (+ embedder fallback)   las.*
  ASR-PARTIAL las.* (+ fallback)           las.* except las.decoder.acous_out
  ALL-PARTIAL everything matching          las.*
  ALL/other  everything matching           everything loaded
  resume/restart: full params + optimizer state (handled by the trainer)
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch


def iter_paths(tree: Any, prefix: Tuple = ()) -> Iterable[Tuple[Tuple, Any]]:
    """Yield (path_tuple, leaf) over nested dict/list pytrees."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_paths(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def path_str(path: Tuple) -> str:
    return ".".join(path)


def get_path(tree: Any, path: Tuple):
    node = tree
    for p in path:
        if isinstance(node, (list, tuple)):
            node = node[int(p)]
        else:
            node = node[p]
    return node


def has_path(tree: Any, path: Tuple) -> bool:
    node = tree
    for p in path:
        if isinstance(node, (list, tuple)):
            i = int(p)
            if i >= len(node):
                return False
            node = node[i]
        elif isinstance(node, dict) and p in node:
            node = node[p]
        else:
            return False
    return True


def map_with_path(tree: Any, fn: Callable[[str, Any], Any], prefix: Tuple = ()):
    """Rebuild the tree applying fn(path_str, leaf) at every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(
            map_with_path(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)
        )
    return fn(path_str(prefix), tree)


def as_leaf(value, like: torch.Tensor) -> torch.Tensor:
    """`value` (a tensor or numpy array) as a new tensor with the dtype and
    device of `like`."""
    return torch.as_tensor(value).to(device=like.device, dtype=like.dtype).clone()


def copy_matching(
    params: Any,
    loaded: Any,
    predicate: Callable[[str], bool],
    logger=None,
) -> Tuple[Any, List[str]]:
    """Overlay `loaded` values onto `params` where the path matches the
    predicate, exists in both, and shapes agree (the reference asserts shape
    equality, ref: trainer_base.py:254)."""
    loaded_names: List[str] = []

    def fn(name: str, leaf):
        path = tuple(name.split("."))
        if predicate(name) and has_path(loaded, path):
            cand = get_path(loaded, path)
            if tuple(cand.shape) == tuple(leaf.shape):
                loaded_names.append(name)
                return as_leaf(cand, leaf)
        if logger is not None:
            logger.info("not preloaded - %s", name)
        return leaf

    new_params = map_with_path(params, fn)
    return new_params, loaded_names


def trainable_mask(params: Any, frozen_predicate: Callable[[str], bool]):
    """Boolean pytree: True = trainable (ref: requires_grad analog).
    emb_dyn_ave is always frozen (a buffer, not a parameter)."""

    def fn(name: str, leaf):
        if name == "emb_dyn_ave":
            return False
        return not frozen_predicate(name)

    return map_with_path(params, fn)


def apply_load_mode(
    params: Any,
    loaded: Optional[Any],
    load_mode: Optional[str],
    load_freeze: bool,
    logger=None,
):
    """Returns (params, trainable_mask_tree) for the non-resume load modes
    (ref: trainer_base.py:229-414)."""
    load_mode = load_mode or "null"

    def never(name: str) -> bool:
        return False

    if loaded is None or load_mode in ("null", "None"):
        return params, trainable_mask(params, never)

    def _embedder_fallback(params_new, loaded_names):
        """ref: trainer_base.py:299-313 — if the ckpt lacks the LAS decoder
        embedder, alias it from the ckpt's enc_embedder."""
        p = ("las", "decoder", "embedder")
        if (
            "las.decoder.embedder" not in loaded_names
            and has_path(params_new, p)
            and has_path(loaded, ("enc_embedder",))
        ):
            cand = get_path(loaded, ("enc_embedder",))
            tgt = get_path(params_new, p)
            if tuple(cand.shape) == tuple(tgt.shape):
                params_new["las"]["decoder"]["embedder"] = as_leaf(cand, tgt)
                if logger is not None:
                    logger.info(
                        "assigning las.decoder.embedder with enc_embedder"
                    )
        return params_new

    if load_mode == "LAS":
        pred = lambda n: n.startswith("las.encoder")
        params, names = copy_matching(params, loaded, pred, logger)
        frozen = pred if load_freeze else never
        return params, trainable_mask(params, frozen)

    if load_mode == "ASR":
        pred = lambda n: n.startswith("las.")
        params, names = copy_matching(params, loaded, pred, logger)
        params = _embedder_fallback(params, names)
        frozen = pred if load_freeze else never
        return params, trainable_mask(params, frozen)

    if load_mode == "ASR-PARTIAL":
        pred = lambda n: n.startswith("las.")
        params, names = copy_matching(params, loaded, pred, logger)
        params = _embedder_fallback(params, names)
        if load_freeze:
            frozen = lambda n: n.startswith("las.") and (
                "las.decoder.acous_out" not in n
            )
        else:
            frozen = never
        return params, trainable_mask(params, frozen)

    if load_mode == "ALL-PARTIAL":
        params, names = copy_matching(params, loaded, lambda n: True, logger)
        frozen = (lambda n: "las" in n) if load_freeze else never
        return params, trainable_mask(params, frozen)

    # default: 'ALL' — load everything that matches
    params, names = copy_matching(params, loaded, lambda n: True, logger)
    loaded_set = set(names)
    frozen = (lambda n: n in loaded_set) if load_freeze else never
    return params, trainable_mask(params, frozen)
