"""Optimizer: global-norm clip, Adam with torch's defaults, and the
reference LR schedule (port of stjep_tpu/train/optim.py).

The JAX package chains optax.clip_by_global_norm -> scale_by_adam(0.9,
0.999, 1e-8) -> -lr, with the LR written into the state every step. Here
the clip is written out as optax computes it (`g * max_norm / norm` only
when norm >= max_norm; torch's clip_grad_norm_ adds 1e-6 to the norm), and
Adam is `torch.optim.Adam`, the same update, which steps the parameters in
place; its moments take each parameter's dtype, as optax's do (bf16 under
bf16 params).

Freezing (`trainable_mask`, a tree of bools like the params, True =
trainable): JAX wraps the chain in `optax.multi_transform` with
`set_to_zero` for frozen leaves, so the clip's global norm is taken over
the trainable leaves only, and frozen leaves get no update and no Adam
state. Here Adam holds only the trainable leaves and the clip reads only
their gradients.

`state_tree` / `load_state_tree` map the Adam state to optax's state tree,
leaf by leaf (the clip's empty state, scale_by_adam's count/mu/nu, the
injected step_size, under multi_transform's "train"/"freeze" branches when
there is a mask), which is what a checkpoint stores.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from stjep_tpu_torch.bridge import leaves, named_leaves


def reference_lr(step, init_lr: float, peak_lr: float,
                 warmup_steps: int) -> float:
    """ref: trainer_base.py:135-154. Pure host math, called every step:
    warmup_steps <= 0 keeps init_lr; up to warmup_steps the LR moves
    linearly from init_lr to peak_lr (downward when peak < init); after it
    decays as peak * step^-0.5 * warmup^0.5."""
    if warmup_steps <= 0:
        return float(init_lr)
    step = float(step)
    if step <= warmup_steps:
        return step * (peak_lr - init_lr) / warmup_steps + init_lr
    return peak_lr * max(step, 1.0) ** -0.5 * warmup_steps ** 0.5


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    max_norm, else each t / norm * max_norm. No host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _map_tree(tree: Any, fn, it) -> Any:
    """The structure of `tree` with each leaf replaced by fn(next(it))."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, it) for v in tree)
    return fn(next(it))


class Optimizer:
    """clip -> Adam, in place on the trainable leaves of a params tree."""

    def __init__(self, max_grad_norm: float = 1.0,
                 trainable_mask: Optional[Any] = None):
        self.max_grad_norm = max_grad_norm
        self.mask = trainable_mask
        self.trainable = (None if trainable_mask is None
                          else [bool(m) for m in leaves(trainable_mask)])

    @property
    def clips(self) -> bool:
        return bool(self.max_grad_norm and self.max_grad_norm > 0)

    def _select(self, xs: List) -> List:
        if self.trainable is None:
            return list(xs)
        return [x for x, keep in zip(xs, self.trainable, strict=True) if keep]

    def init(self, params: Dict) -> torch.optim.Adam:
        """The optimizer state: Adam over the tree's trainable leaves, LR 0
        until set_lr writes it."""
        return torch.optim.Adam(self._select(leaves(params)), lr=0.0,
                                betas=(0.9, 0.999), eps=1e-8)

    def update(self, grads: List[torch.Tensor], opt_state: torch.optim.Adam):
        """One step from grads, in the order of bridge.leaves(params);
        frozen leaves' gradients are ignored."""
        grads = self._select(grads)
        if self.clips:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        ps = opt_state.param_groups[0]["params"]
        for p, g in zip(ps, grads, strict=True):
            p.grad = g
        opt_state.step()
        for p in ps:
            p.grad = None

    # ------------------------------------------------ optax's state tree

    def state_tree(self, params: Dict, opt_state: torch.optim.Adam) -> Dict:
        """The state as `make_optimizer(max_grad_norm, mask).init(params)`
        lays it out in the JAX package after as many updates (tensors on the
        host; frozen leaves' moments are `{}`, optax's MaskedNode)."""
        ps = leaves(params)
        keep = self.trainable or [True] * len(ps)
        count = 0
        moments = {"mu": [], "nu": []}
        for p, k in zip(ps, keep):
            st = opt_state.state.get(p, {}) if k else None
            if st:
                count = int(st["step"])
            for key, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                moments[key].append(
                    {} if not k else (st[name] if st else torch.zeros_like(p))
                    .detach().cpu())
        n = torch.tensor(count, dtype=torch.int32)
        adam = {"count": n}
        for key, vals in moments.items():
            adam[key] = _map_tree(params, lambda v: v, iter(vals))
        lr = float(opt_state.param_groups[0]["lr"])
        inject = {"count": n.clone(),
                  "hyperparams": {"step_size": torch.tensor(-lr, dtype=torch.float32)},
                  "hyperparams_states": {}, "inner_state": {}}
        chain = [{}, adam, inject] if self.clips else [adam, inject]
        chain = {str(i): s for i, s in enumerate(chain)}
        if self.mask is None:
            return chain
        return {"inner_states": {"freeze": {"inner_state": {}},
                                 "train": {"inner_state": chain}}}

    def load_state_tree(self, params: Dict, opt_state: torch.optim.Adam,
                        tree: Dict):
        """Set Adam's state (count, moments, LR) from a state tree of
        `state_tree`'s layout, in place; lists may come as dicts keyed "0",
        "1", ... (a checkpoint's state dict)."""
        if self.mask is not None:
            tree = tree["inner_states"]["train"]["inner_state"]
        adam, inject = (tree["1"], tree["2"]) if self.clips else (tree["0"], tree["1"])
        count = int(torch.as_tensor(adam["count"]))
        keep = self.trainable or [True] * len(leaves(params))
        for (name, p), k in zip(named_leaves(params), keep, strict=True):
            if not k:
                continue
            mu, nu = (_lookup(adam[key], name) for key in ("mu", "nu"))
            opt_state.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(mu).to(device=p.device, dtype=p.dtype).clone(),
                "exp_avg_sq": torch.as_tensor(nu).to(device=p.device, dtype=p.dtype).clone()}
        set_lr(opt_state, -float(torch.as_tensor(inject["hyperparams"]["step_size"])))


def _lookup(tree: Any, name: str):
    """The leaf at bridge path `name` ("/a/0/w") of a tree whose lists may
    be stored as dicts keyed "0", "1", ... (a checkpoint's state dict)."""
    for part in name.strip("/").split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def make_optimizer(max_grad_norm: float = 1.0,
                   trainable_mask: Optional[Any] = None) -> Optimizer:
    """clip-by-global-norm (when max_grad_norm > 0) -> Adam (torch
    defaults), over the leaves `trainable_mask` marks True (all without a
    mask); the LR lives in the state, written by set_lr."""
    return Optimizer(max_grad_norm, trainable_mask)


def set_lr(opt_state: torch.optim.Adam, lr: float) -> torch.optim.Adam:
    """Write the learning rate for the next update (the reference writes
    param_group['lr'] every step)."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state
